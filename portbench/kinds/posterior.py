"""Posterior rebuilds: a closed loop of ``GP.update(hyp=..., compute_posterior
=True)`` on the configuration's data, each step a fresh set of S vectors
from the seed, so each step is a full rebuild (self tile, jittered
Cholesky, alpha) and nothing predicts.

Set-up makes the data and one build.  ``posterior_s`` is the window over
its builds.  Judged: every sample of the last build (its stored factor,
alpha, noise multiplier and parametrization) and the alphas of
``judged_earlier_builds`` builds drawn from the seed, against the
reference's factorization of the same vectors.
"""

import math

import numpy as np
import torch

from .. import common
from ..reference import gp as ref
from ..work import posterior as w_posterior

# The port's Cholesky parametrization holds where min(sn2) * mult is at
# least this (the model's high-noise split).
LCHOL_THRESHOLD = 1e-6
BLOCK = 2048


class Runner:
    def __init__(self, cfg, traffic, seed, devices):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = devices[0]
        self.builds = []

    def setup(self):
        cfg, dev = self.cfg, self.device
        X, y = common.rows(cfg["N"], cfg, common.generator(self.seed, "data", dev),
                           dev)
        self.X, self.y = common.host(X), common.host(y)
        H0 = common.hyps(cfg["serve_hyp"], cfg["S"], cfg["D"],
                         common.generator(self.seed, "hyp", dev), dev)
        self.gp = common.make_gp(cfg, dev)
        self.gp.update(X_new=self.X, y_new=self.y, hyp=H0)
        common.sync(dev)
        self.g_steps = common.generator(self.seed, "steps", dev)
        N = cfg["N"]
        self.tiles = [(N, N, cfg["D"], True)] * cfg["S"]

    def prepare(self):
        # Hold no posterior across a step: the port frees the old factors
        # before it builds the new ones.
        self.last = None
        cfg = self.cfg
        self.H = common.hyps(cfg["serve_hyp"], cfg["S"], cfg["D"], self.g_steps,
                             self.device)

    def step(self):
        self.gp.update(hyp=self.H, compute_posterior=True)
        common.sync(self.device)
        cfg = self.cfg
        return {"units": 1,
                "flops": w_posterior.flops(cfg["N"], cfg["D"], cfg["S"]),
                "tiles": self.tiles, "vjps": [], "norm": 1}

    def after(self, rec):
        alphas = torch.cat([p.alpha for p in self.gp.posteriors], dim=1).clone()
        self.builds.append((self.H, alphas))
        rec["finite"] = bool(torch.isfinite(alphas).all())
        self.last = list(self.gp.posteriors)

    def end_to_end(self, records, window_s):
        return {"posterior_s": window_s / len(records)}

    def release(self):
        self.gp = None

    def _sample(self):
        if not hasattr(self, "_picked"):
            rng = common.host_rng(self.seed, "judge")
            k = int(self.traffic["judged_earlier_builds"])
            earlier = common.choose(rng, len(self.builds) - 1, k, last=False)
            self._picked = earlier + [len(self.builds) - 1]
        return self._picked

    def judged_outputs(self):
        return {
            "upper": [(p.L, 1.0) for p in self.last],
            "mult": [p.sn2_mult for p in self.last],
            "chol": [bool(p.L_chol) for p in self.last],
            "alpha": [common.host(self.builds[i][1]).T for i in self._sample()],
        }

    def reference_outputs(self, prec):
        t = lambda a: prec.tensor(a, self.device)  # noqa: E731
        X, y = t(self.X), t(self.y)
        out = {"upper": [], "mult": [], "chol": [], "alpha": []}
        picked = self._sample()
        with torch.no_grad():
            for i in picked:
                alphas = []
                for h in self.builds[i][0]:
                    fac = ref.Factor(t(h), X, y, prec)
                    alphas.append(common.host(fac.alpha[:, 0]))
                    if i == picked[-1]:
                        sl = float(fac.sn2) * fac.mult
                        out["upper"].append((fac.L.mT, 1.0 / math.sqrt(sl)))
                        out["mult"].append(fac.mult)
                        out["chol"].append(sl >= LCHOL_THRESHOLD)
                    del fac
                out["alpha"].append(np.stack(alphas))
        return out

    def compare(self, out, want):
        factor_gap = 0.0
        for (a, sa), (b, sb) in zip(out["upper"], want["upper"]):
            num = den = 0.0
            for j in range(0, a.shape[1], BLOCK):
                A = a[:, j:j + BLOCK].double() * sa
                B = b[:, j:j + BLOCK].double() * sb
                num += float(((A - B) ** 2).sum())
                den += float((B * B).sum())
                del A, B
            factor_gap = max(factor_gap, math.sqrt(num / den))
        alpha_gap = max(
            float(np.max(np.linalg.norm(p - q, axis=1)
                         / np.linalg.norm(q, axis=1)))
            for p, q in zip(out["alpha"], want["alpha"]))
        mismatch = sum(
            int(m1 != m2 or c1 != c2)
            for m1, m2, c1, c2 in zip(out["mult"], want["mult"], out["chol"],
                                      want["chol"]))
        return {"factor_gap": factor_gap, "alpha_gap": alpha_gap,
                "branch_mismatch": float(mismatch)}
