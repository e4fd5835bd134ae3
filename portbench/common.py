"""What the traffic kinds share: seeds, the data of a configuration, and
the GP under test.

Every input comes from ``--seed`` through :func:`generator`, one stream
per purpose, so the number of steps a run takes never changes the data
of another stream.  Inputs are drawn on the run's device with a
``torch.Generator`` and handed to the port as float64 host arrays of
float32 values: the port's API takes host arrays, and the reference then
reads exactly the numbers the card computes with.  The rules follow
``chip_smoke.py``'s ``_data``, ``_train_data`` and ``_new_rows``: inputs
x ~ N(0, I), targets sum(sin x) + noise_sd * N(0, 1), hyperparameters a
base vector plus jitter_sd * N(0, 1) a sample.
"""

import numpy as np
import torch

STREAMS = ("data", "hyp", "steps", "judge", "pool")


def sub_seed(seed, stream):
    """A 64-bit seed for ``stream`` of the run seeded with ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, STREAMS.index(stream)])
    return int(ss.generate_state(1, dtype=np.uint64)[0])


def generator(seed, stream, device):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def host_rng(seed, stream):
    """A numpy generator of ``stream``, for choices made on the host (which
    outputs are judged)."""
    return np.random.default_rng(sub_seed(seed, stream))


def host(t):
    return t.double().cpu().numpy()


def rows(n, cfg, g, device):
    """n rows (X (n, D), y (n, 1)) of the configuration's function, drawn
    in float32 on ``device``."""
    X = torch.randn((n, cfg["D"]), generator=g, device=device,
                    dtype=torch.float32)
    eps = torch.randn((n, 1), generator=g, device=device, dtype=torch.float32)
    y = torch.sin(X).sum(dim=1, keepdim=True) + cfg["noise_sd"] * eps
    return X, y


def points(n, cfg, g, device):
    """n test inputs (n, D), float32 on ``device``."""
    return torch.randn((n, cfg["D"]), generator=g, device=device,
                       dtype=torch.float32)


def hyps(rule, count, D, g, device):
    """``count`` hyperparameter vectors [log ell (D), log sf, log sn,
    mean] of the rule ``{"log_ell", "log_sf", "log_sn", "mean",
    "jitter_sd"}``, as a float64 host array of float32 draws."""
    base = torch.tensor([rule["log_ell"]] * D
                        + [rule["log_sf"], rule["log_sn"], rule["mean"]],
                        dtype=torch.float64, device=device)
    jit = torch.randn((count, D + 3), generator=g, device=device,
                      dtype=torch.float32)
    return host(base + rule["jitter_sd"] * jit.double())


def make_gp(cfg, device):
    """The GP of the configuration: ARD squared exponential, constant
    mean, constant Gaussian noise, float32 on ``device``."""
    import gpyreg_tpu_torch as gt

    if cfg["model"] != "ard_se_const_gauss" or cfg["dtype"] != "float32":
        raise ValueError(f"no GP for model {cfg['model']} in {cfg['dtype']}")
    return gt.GP(
        cfg["D"],
        gt.covariance_functions.SquaredExponential(),
        gt.mean_functions.ConstantMean(),
        gt.noise_functions.GaussianNoise(constant_add=True),
        dtype=np.float32,
        device=device,
    )


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def choose(rng, count, k, last=True):
    """Indices of ``k`` of ``count`` items drawn by ``rng``, the last
    item always among them when ``last``."""
    k = min(k, count)
    if k <= 0:
        return []
    if last:
        rest = rng.choice(count - 1, size=k - 1, replace=False).tolist()
        return sorted(rest + [count - 1])
    return sorted(rng.choice(count, size=k, replace=False).tolist())


def moment_gaps(out, want):
    """The largest absolute gaps of the predictive means and variances."""
    return {"mean_gap": float(np.max(np.abs(out["mu"] - want["mu"]))),
            "var_gap": float(np.max(np.abs(out["s2"] - want["s2"])))}
