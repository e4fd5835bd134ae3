"""Training: a closed loop of batched NLML-and-gradient calls over the
configuration's B hyperparameter vectors, through
``core.nlml.get_fns(...)["nlz_grad"]`` on ``GP._obj_args()``, the inner
loop of every MAP fit and gradient sampler.

Call i evaluates the set-up's vectors plus ``perturb_step * i``, as
bench.py does, so no call repeats.  Set-up builds the GP's data on the
card and warms one call.  ``nlml_grad_evals_per_s`` is the vectors
evaluated over the window.  Judged: the last call and ``judged_calls -
1`` more drawn from the seed, each vector's value and gradient against
the reference's.
"""

import numpy as np
import torch

from .. import common
from ..reference import gp as ref
from ..work import nlml_grad as w_nlml_grad


class Runner:
    def __init__(self, cfg, traffic, seed, devices):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = devices[0]
        self.calls = []

    def setup(self):
        cfg, dev = self.cfg, self.device
        X, y = common.rows(cfg["N"], cfg, common.generator(self.seed, "data", dev),
                           dev)
        self.X, self.y = common.host(X), common.host(y)
        self.H = common.hyps(cfg["train_hyp"], cfg["B"], cfg["D"],
                             common.generator(self.seed, "hyp", dev), dev)
        self.gp = common.make_gp(cfg, dev)
        self.gp.update(X_new=self.X, y_new=self.y, hyp=self.H,
                       compute_posterior=False)
        fns, self.args = self.gp._obj_args()
        self.fn = fns["nlz_grad"]
        self.fn(self.H, *self.args)
        common.sync(dev)
        N, D = cfg["N"], cfg["D"]
        self.tiles = [(N, N, D, True)] * cfg["B"]
        self.vjps = [(N, D)] * cfg["B"]

    def prepare(self):
        self.h = self.H + float(self.traffic["perturb_step"]) * len(self.calls)

    def step(self):
        v, g = self.fn(self.h, *self.args)
        common.sync(self.device)
        self.calls.append((self.h, v, g))
        cfg = self.cfg
        return {"units": cfg["B"],
                "flops": cfg["B"] * w_nlml_grad.flops(cfg["N"], cfg["D"]),
                "tiles": self.tiles, "vjps": self.vjps, "norm": 1}

    def after(self, rec):
        _, v, g = self.calls[-1]
        rec["finite"] = bool(torch.isfinite(v).all() and torch.isfinite(g).all())

    def end_to_end(self, records, window_s):
        return {"nlml_grad_evals_per_s":
                sum(r["units"] for r in records) / window_s}

    def release(self):
        self.gp = self.fn = self.args = None

    def _sample(self):
        if not hasattr(self, "_picked"):
            rng = common.host_rng(self.seed, "judge")
            self._picked = common.choose(rng, len(self.calls),
                                         int(self.traffic["judged_calls"]))
        return self._picked

    def judged_outputs(self):
        picked = [self.calls[i] for i in self._sample()]
        return {"v": np.concatenate([common.host(c[1]) for c in picked]),
                "g": np.concatenate([common.host(c[2]) for c in picked])}

    def reference_outputs(self, prec):
        t = lambda a: prec.tensor(a, self.device)  # noqa: E731
        X, y = t(self.X), t(self.y)
        vs, gs = [], []
        with torch.no_grad():
            for i in self._sample():
                for h in self.calls[i][0]:
                    v, g = ref.nlml_grad(t(h), X, y, prec)
                    vs.append(float(v))
                    gs.append(common.host(g))
        return {"v": np.array(vs), "g": np.stack(gs)}

    def compare(self, out, want):
        scale = np.max(np.abs(want["g"]), axis=1, keepdims=True)
        return {
            "value_gap": float(np.max(np.abs(out["v"] - want["v"])
                                      / np.abs(want["v"]))),
            "grad_gap": float(np.max(np.abs(out["g"] - want["g"]) / scale)),
        }
