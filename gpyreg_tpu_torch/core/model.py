"""Model specification and the mean/noise/covariance evaluators.

Port of ``gpyreg_tpu/core/model.py`` (the whole module).  A
:class:`ModelSpec` is a frozen description of the GP model family
(covariance kind, mean kind, noise feature flags, dimension, output
warping).  The hyperparameter vector layout matches the reference
exactly: cov | noise | mean | outwarp (gaussian_process.py:174,
matlab/gplite/private/gplite_core.m:16).

The ``outwarp`` field names an output warp of
``outwarp_functions.OUTWARP_KINDS``; its hyperparameter count comes from
that module's ``outwarp_hyp_count``.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kernels import cov_hyp_count, kernel_matrix
from ..outwarp_functions import OUTWARP_KINDS, outwarp_hyp_count

COV_KINDS = (
    "se",
    "m1",
    "m3",
    "m5",
    "rq",
    "se_iso",
    "m1_iso",
    "m3_iso",
    "m5_iso",
)
MEAN_KINDS = (
    "zero",
    "const",
    "negquad",
    # gplite-oracle means (gplite_meanfun.m:10-18)
    "linear",
    "quad",
    "posquad",
    "se_mean",
    "negse_mean",
)
# User-supplied mean functions, keyed by name so the ModelSpec stays a
# frozen string-keyed description: spec.mean == "custom:<name>"
# dispatches here.  Entries are (value_fn, hyp_count_fn) with
# value_fn(hyp_mean, X) -> (N,) on torch tensors and hyp_count_fn(D) -> int.
_CUSTOM_MEANS = {}


def register_custom_mean(name: str, value_fn, hyp_count):
    """Register a user mean function under ``name``.

    ``value_fn(hyp_mean, X) -> (N,)`` works on torch tensors;
    ``hyp_count`` is an int or a callable ``D -> int``.  Re-registering
    the same name with the same callable is a no-op; with a different
    callable it raises (a live name never silently changes meaning).
    """
    count_fn = hyp_count if callable(hyp_count) else (lambda D: int(hyp_count))
    if name in _CUSTOM_MEANS:
        if _CUSTOM_MEANS[name][0] is not value_fn:
            raise ValueError(
                f"A different mean function is already registered under "
                f"{name!r}; pick a unique name."
            )
        return f"custom:{name}"
    _CUSTOM_MEANS[name] = (value_fn, count_fn)
    return f"custom:{name}"


def custom_mean_entry(kind: str):
    name = kind.split(":", 1)[1]
    if name not in _CUSTOM_MEANS:
        raise ValueError(
            f"Custom mean {name!r} is not registered (construct the "
            f"CustomMean / call register_custom_mean first)."
        )
    return _CUSTOM_MEANS[name]


@dataclass(frozen=True)
class ModelSpec:
    """GP model family description (hashable)."""

    D: int
    cov: str  # one of COV_KINDS
    mean: str  # one of MEAN_KINDS or "custom:<name>"
    noise_constant: bool  # constant_add
    noise_user: int  # 0: none, 1: add s2 as-is, 2: scaled by exp(hyp)
    noise_rectified: bool  # rectified-linear output-dependent noise
    outwarp: str = None  # None or an OUTWARP_KINDS entry

    def __post_init__(self):
        if self.cov not in COV_KINDS:
            raise ValueError(f"Unknown covariance kind {self.cov}")
        if self.mean.startswith("custom:"):
            custom_mean_entry(self.mean)  # raises if unregistered
        elif self.mean not in MEAN_KINDS:
            raise ValueError(f"Unknown mean kind {self.mean}")
        if self.outwarp is not None and self.outwarp not in OUTWARP_KINDS:
            raise ValueError(f"Unknown output warping kind {self.outwarp}")

    @property
    def cov_N(self) -> int:
        return cov_hyp_count(self.cov, self.D)

    @property
    def mean_N(self) -> int:
        # reference mean_functions.py:27,155,284; gplite_meanfun.m:57-127
        if self.mean.startswith("custom:"):
            return custom_mean_entry(self.mean)[1](self.D)
        return {
            "zero": 0,
            "const": 1,
            "negquad": 1 + 2 * self.D,
            "linear": 1 + self.D,
            "quad": 1 + 2 * self.D,
            "posquad": 1 + 2 * self.D,
            "se_mean": 2 + 2 * self.D,
            "negse_mean": 2 + 2 * self.D,
        }[self.mean]

    @property
    def noise_N(self) -> int:
        # reference noise_functions.py:43-59
        return (
            int(self.noise_constant)
            + int(self.noise_user == 2)
            + 2 * int(self.noise_rectified)
        )

    @property
    def outwarp_N(self) -> int:
        return 0 if self.outwarp is None else outwarp_hyp_count(self.outwarp)

    @property
    def hyp_N(self) -> int:
        return self.cov_N + self.noise_N + self.mean_N + self.outwarp_N

    def split_hyp(self, hyp):
        """(cov, noise, mean) slices of a hyperparameter vector; a leading
        sample axis, when present, is kept."""
        c, n, m = self.cov_N, self.noise_N, self.mean_N
        return (
            hyp[..., :c],
            hyp[..., c : c + n],
            hyp[..., c + n : c + n + m],
        )

    def outwarp_hyp(self, hyp):
        return hyp[..., self.cov_N + self.noise_N + self.mean_N :]


def mean_value(spec: ModelSpec, hyp_mean, X):
    """Mean function m(X), shape (N,).

    Parity: reference mean_functions.py (ZeroMean :126, ConstantMean :255,
    NegativeQuadratic :384-388) and gplite_meanfun.m for the others.
    """
    N, D = X.shape
    if spec.mean.startswith("custom:"):
        value_fn = custom_mean_entry(spec.mean)[0]
        return torch.reshape(value_fn(hyp_mean, X), (N,))
    if spec.mean == "zero":
        return torch.zeros((N,), dtype=X.dtype, device=X.device)
    if spec.mean == "const":
        return hyp_mean[0] * torch.ones((N,), dtype=X.dtype, device=X.device)
    if spec.mean == "linear":
        return hyp_mean[0] + X @ hyp_mean[1 : 1 + D]
    if spec.mean == "quad":
        return (
            hyp_mean[0]
            + X @ hyp_mean[1 : 1 + D]
            + (X**2) @ hyp_mean[1 + D : 1 + 2 * D]
        )
    if spec.mean in ("negquad", "posquad"):
        sgn = -1.0 if spec.mean == "negquad" else 1.0
        m0 = hyp_mean[0]
        xm = hyp_mean[1 : 1 + D]
        omega = torch.exp(hyp_mean[1 + D : 1 + 2 * D])
        z2 = ((X - xm) / omega) ** 2
        return m0 + sgn * 0.5 * torch.sum(z2, dim=1)
    if spec.mean in ("se_mean", "negse_mean"):
        sgn = 1.0 if spec.mean == "se_mean" else -1.0
        m0 = hyp_mean[0]
        xm = hyp_mean[1 : 1 + D]
        omega = torch.exp(hyp_mean[1 + D : 1 + 2 * D])
        hgt = torch.exp(hyp_mean[1 + 2 * D])
        z2 = ((X - xm) / omega) ** 2
        return m0 + sgn * hgt * torch.exp(-0.5 * torch.sum(z2, dim=1))
    raise ValueError(f"Unknown mean kind {spec.mean}")


def noise_variance(spec: ModelSpec, hyp_noise, y, s2, dtype):
    """Observation noise variance sn2.

    A 0-d tensor if the noise is input/output independent, else (N,1) —
    mirroring reference noise_functions.py:179-283.  ``y`` and ``s2`` are
    (N,1) tensors or None.
    """
    device = hyp_noise.device
    i = 0
    if spec.noise_constant:
        sn2 = torch.exp(2.0 * hyp_noise[i])
        i += 1
    else:
        # Floor at the float64 machine spacing in every dtype, reference
        # noise_functions.py:251.
        sn2 = torch.tensor(np.finfo(np.float64).eps, dtype=dtype, device=device)

    if spec.noise_user == 1 and s2 is not None:
        sn2 = sn2 + s2
    elif spec.noise_user == 2:
        if s2 is not None:
            sn2 = sn2 + torch.exp(hyp_noise[i]) * s2
        i += 1

    if spec.noise_rectified:
        if y is not None:
            y_thresh = hyp_noise[i]
            w2 = torch.exp(2.0 * hyp_noise[i + 1])
            zz = torch.clamp(y_thresh - y, min=0.0)
            sn2 = sn2 + w2 * zz**2
        i += 2

    return sn2


def cov_matrix(spec: ModelSpec, hyp_cov, X, Z=None, diag=False):
    return kernel_matrix(spec.cov, hyp_cov, X, Z=Z, diag=diag)
