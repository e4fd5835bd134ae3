"""Serving: closed-loop requests of ``points_per_request`` fresh test
points each, answered by ``GP.predict``'s mixture mean and variance over
the configuration's S posterior samples.

Set-up builds the posterior (``GP.update`` with S vectors) and warms one
call at each test-point chunk shape the requests use (a full chunk and
the ragged last one).  A step is one whole request; ``predict_pts_per_s``
is every point over the summed time of the window's requests.  Judged:
``judged_points`` points drawn from the seed over every request of the
run, against the reference's mixture at the same points.
"""

import numpy as np
import torch

from .. import common
from ..reference import gp as ref
from ..work import predict as w_predict


class Runner:
    def __init__(self, cfg, traffic, seed, devices):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = devices[0]
        self.M = int(traffic["points_per_request"])
        self.requests = []

    def setup(self):
        cfg, dev = self.cfg, self.device
        X, y = common.rows(cfg["N"], cfg, common.generator(self.seed, "data", dev),
                           dev)
        self.X, self.y = common.host(X), common.host(y)
        self.H = common.hyps(cfg["serve_hyp"], cfg["S"], cfg["D"],
                             common.generator(self.seed, "hyp", dev), dev)
        self.gp = common.make_gp(cfg, dev)
        self.gp.update(X_new=self.X, y_new=self.y, hyp=self.H)
        N, M, S = cfg["N"], self.M, cfg["S"]
        chunk = self.gp._predict_chunk(N, M)
        full = (M - 1) // chunk
        tail = M - chunk * full
        D = cfg["D"]
        self.tiles = S * ([(N, chunk, D, False)] * full + [(N, tail, D, False)])
        warm = chunk + (tail if full else 0)
        xs = common.points(warm, cfg, common.generator(self.seed, "pool", dev),
                           dev)
        self.gp.predict(common.host(xs))
        self.g_steps = common.generator(self.seed, "steps", dev)

    def prepare(self):
        self.xs = common.host(common.points(self.M, self.cfg, self.g_steps,
                                            self.device))

    def step(self):
        mu, s2 = self.gp.predict(self.xs)
        self.requests.append((self.xs, mu[:, 0], s2[:, 0]))
        cfg = self.cfg
        return {"units": self.M,
                "flops": w_predict.flops(cfg["N"], cfg["D"], self.M, cfg["S"]),
                "tiles": self.tiles, "vjps": [], "norm": self.M / 1000}

    def after(self, rec):
        _, mu, s2 = self.requests[-1]
        rec["finite"] = bool(np.isfinite(mu).all() and np.isfinite(s2).all())

    def end_to_end(self, records, window_s):
        return {"predict_pts_per_s": sum(r["units"] for r in records) / window_s}

    def release(self):
        self.gp = None

    def _sample(self):
        if not hasattr(self, "_picked"):
            rng = common.host_rng(self.seed, "judge")
            total = self.M * len(self.requests)
            k = min(int(self.traffic["judged_points"]), total)
            self._picked = np.sort(rng.choice(total, size=k, replace=False))
        return self._picked

    def judged_outputs(self):
        idx = self._sample()
        mu = np.concatenate([r[1] for r in self.requests])[idx]
        s2 = np.concatenate([r[2] for r in self.requests])[idx]
        return {"mu": mu, "s2": s2}

    def reference_outputs(self, prec):
        idx = self._sample()
        xs = np.concatenate([r[0] for r in self.requests])[idx]
        t = lambda a: prec.tensor(a, self.device)  # noqa: E731
        with torch.no_grad():
            mu, s2 = ref.predict_mixture(t(self.H), t(self.X), t(self.y), t(xs),
                                         prec)
        return {"mu": common.host(mu), "s2": common.host(s2)}

    def compare(self, out, want):
        return common.moment_gaps(out, want)
