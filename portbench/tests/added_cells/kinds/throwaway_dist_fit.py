"""A four-card kind for the harness's own tests: a closed loop of
``parallel.dist_exact.dist_exact_fit`` over a mesh of the cell's four
devices, each step a fresh hyperparameter vector from the seed, on the
configuration's float32 data with its panel width ``b``.

Set-up draws the data on the first device and warms one fit.
``dist_fit_s`` is the window over its fits.  Judged: the NLML of the last
fit and of ``judged_fits - 1`` more drawn from the seed, against the
float64 reference's.
"""

import numpy as np
import torch

from .. import common
from ..reference import gp as ref
from ..work import posterior as w_posterior

CHIPS = 4


class Runner:
    def __init__(self, cfg, traffic, seed, devices):
        if len(devices) != CHIPS:
            raise ValueError(f"a {CHIPS}-card kind was given {len(devices)} "
                             "devices")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.devices = list(devices)
        self.fits = []

    def _fit(self, h):
        from gpyreg_tpu_torch.parallel import dist_exact

        post = dist_exact.dist_exact_fit(self.spec, self.mesh, h, self.Xd,
                                         self.yd, b=int(self.cfg["b"]))
        for d in self.devices:
            common.sync(d)
        return post.nlml

    def setup(self):
        from gpyreg_tpu_torch.core.model import ModelSpec
        from gpyreg_tpu_torch.parallel.mesh import make_mesh

        cfg, dev = self.cfg, self.devices[0]
        self.Xd, self.yd = common.rows(cfg["N"], cfg,
                                       common.generator(self.seed, "data", dev),
                                       dev)
        self.X, self.y = common.host(self.Xd), common.host(self.yd)
        self.spec = ModelSpec(D=cfg["D"], cov="se", mean="const",
                              noise_constant=True, noise_user=0,
                              noise_rectified=False)
        self.mesh = make_mesh(devices=self.devices)
        self.g_steps = common.generator(self.seed, "steps", dev)
        self._fit(common.hyps(cfg["serve_hyp"], 1, cfg["D"],
                              common.generator(self.seed, "hyp", dev), dev)[0])

    def prepare(self):
        cfg = self.cfg
        self.h = common.hyps(cfg["serve_hyp"], 1, cfg["D"], self.g_steps,
                             self.devices[0])[0]

    def step(self):
        self.fits.append((self.h, self._fit(self.h)))
        cfg = self.cfg
        return {"units": 1, "flops": w_posterior.flops(cfg["N"], cfg["D"], 1),
                "tiles": [], "vjps": [], "norm": 1}

    def after(self, rec):
        rec["finite"] = bool(torch.isfinite(self.fits[-1][1]))

    def end_to_end(self, records, window_s):
        return {"dist_fit_s": window_s / len(records)}

    def release(self):
        self.mesh = self.Xd = self.yd = None

    def _sample(self):
        if not hasattr(self, "_picked"):
            rng = common.host_rng(self.seed, "judge")
            self._picked = common.choose(rng, len(self.fits),
                                         int(self.traffic["judged_fits"]))
        return self._picked

    def judged_outputs(self):
        return {"nlml": np.array([float(self.fits[i][1])
                                  for i in self._sample()])}

    def reference_outputs(self, prec):
        t = lambda a: prec.tensor(a, self.devices[0])  # noqa: E731
        X, y = t(self.X), t(self.y)
        with torch.no_grad():
            return {"nlml": np.array([
                float(ref.nlml_grad(t(self.fits[i][0]), X, y, prec)[0])
                for i in self._sample()])}

    def compare(self, out, want):
        return {"nlml_gap": float(np.max(np.abs(out["nlml"] - want["nlml"])
                                         / np.abs(want["nlml"])))}
