"""Row-sharded exact posterior builds: a closed loop of
``parallel.dist_exact.dist_exact_fit`` over a mesh of the cell's four
devices, each step one build on a fresh hyperparameter vector from the
seed (``common.hyps``: the base plus jitter_sd * N(0, 1)), on the
configuration's float32 data with its panel width ``b``, ending with
every card synchronized.  A step is the slab build (one cross tile a
card), the panel Cholesky with its copies between cards, the two
substitutions and the NLML.

Set-up draws the data on the first device and warms one build.
``posterior_s`` is the window over its builds.  After each build its
NLML and alpha are pulled to the host and the build is dropped, so no
two builds' slabs are held at once.  Judged: the last build and
``judged_earlier_builds`` more drawn from the seed, against the float64
tile reference (``reference/dist_gp.py``) on the same devices:
``nlml_gap``, the largest relative gap of the NLML, and ``alpha_gap``,
the largest relative 2-norm gap of alpha over the real rows.
"""

import numpy as np
import torch

from .. import common
from ..reference import dist_gp
from ..work import posterior as w_posterior

CHIPS = 4


def _peer_copies():
    """The port's count of copies between devices, or None where the
    program has no such counter."""
    from gpyreg_tpu_torch.parallel import mesh

    counter = getattr(mesh, "PEER_COPIES", None)
    return None if counter is None else counter["copies"]


class Runner:
    def __init__(self, cfg, traffic, seed, devices):
        if len(devices) != CHIPS:
            raise ValueError(f"a {CHIPS}-card kind was given {len(devices)} "
                             "devices")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.devices = list(devices)
        self.builds = []

    def _fit(self, h):
        from gpyreg_tpu_torch.parallel import dist_exact

        post = dist_exact.dist_exact_fit(self.spec, self.mesh, h, self.Xd,
                                         self.yd, b=int(self.cfg["b"]))
        for d in set(self.devices):
            common.sync(d)
        return post

    def setup(self):
        from gpyreg_tpu_torch.core.model import ModelSpec
        from gpyreg_tpu_torch.parallel.dist_exact import plan
        from gpyreg_tpu_torch.parallel.mesh import make_mesh

        cfg, dev = self.cfg, self.devices[0]
        N, D, P = cfg["N"], cfg["D"], CHIPS
        self.Xd, self.yd = common.rows(N, cfg, common.generator(self.seed,
                                                                "data", dev),
                                       dev)
        self.X, self.y = common.host(self.Xd), common.host(self.yd)
        self.spec = ModelSpec(D=D, cov="se", mean="const",
                              noise_constant=True, noise_user=0,
                              noise_rectified=False)
        self.mesh = make_mesh(devices=self.devices)
        # One cross tile a card: its rows of B against every row.
        Np, rows, _ = plan(N, P, min(int(cfg["b"]), max(32, N // P)))
        self.tiles = [(rows, Np, D, False)] * P
        self.g_steps = common.generator(self.seed, "steps", dev)
        self._fit(common.hyps(cfg["serve_hyp"], 1, D,
                              common.generator(self.seed, "hyp", dev), dev)[0])

    def prepare(self):
        cfg = self.cfg
        self.h = common.hyps(cfg["serve_hyp"], 1, cfg["D"], self.g_steps,
                             self.devices[0])[0]

    def step(self):
        before = _peer_copies()
        self.post = self._fit(self.h)
        cfg = self.cfg
        rec = {"units": 1, "flops": w_posterior.flops(cfg["N"], cfg["D"], 1),
               "tiles": self.tiles, "vjps": [], "norm": 1}
        if before is not None:
            rec["peer_copies"] = _peer_copies() - before
        return rec

    def after(self, rec):
        post, self.post = self.post, None
        nlml = float(post.nlml)
        alpha = common.host(post.alpha[: self.cfg["N"], 0])
        del post
        self.builds.append((self.h, nlml, alpha))
        rec["finite"] = bool(np.isfinite(nlml) and np.isfinite(alpha).all())

    def end_to_end(self, records, window_s):
        return {"posterior_s": window_s / len(records)}

    def release(self):
        self.post = self.mesh = self.Xd = self.yd = None

    def _sample(self):
        if not hasattr(self, "_picked"):
            rng = common.host_rng(self.seed, "judge")
            k = int(self.traffic["judged_earlier_builds"])
            earlier = common.choose(rng, len(self.builds) - 1, k, last=False)
            self._picked = earlier + [len(self.builds) - 1]
        return self._picked

    def judged_outputs(self):
        picked = [self.builds[i] for i in self._sample()]
        return {"nlml": np.array([b[1] for b in picked]),
                "alpha": [b[2] for b in picked]}

    def reference_outputs(self, prec):
        nlml, alpha = [], []
        for i in self._sample():
            fac = dist_gp.TileFactor(self.builds[i][0], self.X, self.y, prec,
                                     self.devices)
            nlml.append(fac.nlml)
            alpha.append(fac.alpha)
            fac.release()
            del fac
        return {"nlml": np.array(nlml), "alpha": alpha}

    def compare(self, out, want):
        return {
            "nlml_gap": float(np.max(np.abs(out["nlml"] - want["nlml"])
                                     / np.abs(want["nlml"]))),
            "alpha_gap": max(float(np.linalg.norm(p - q) / np.linalg.norm(q))
                             for p, q in zip(out["alpha"], want["alpha"])),
        }
