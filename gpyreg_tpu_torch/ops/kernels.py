"""Covariance kernel math in PyTorch.

Port of ``gpyreg_tpu/ops/kernels.py`` (the whole module).  Pairwise
squared distances use the norm expansion ``|a|^2 + |b|^2 - 2 a.b`` with
a full-precision matmul, the exactly-zero self-covariance diagonal and
the clamp at zero.

Kernel zoo (parity with reference covariance_functions.py /
isotropic_covariance_functions.py):

- ``se``      squared exponential ARD            (D+1 hyp)
- ``m1/3/5``  Matern 1/2, 3/2, 5/2 ARD           (D+1 hyp)
- ``rq``      rational quadratic ARD             (D+2 hyp)
- ``se_iso``, ``m{1,3,5}_iso`` isotropic variants (2 hyp)

Dispatch: every float32 self- or cross-covariance of a CUDA tensor goes
to the hand-written kernel tile (``ops.tile_kernels``: the self-covariance
through ``KernelSelfFused``, whose backward is the hand-written gradient
tile, the cross-covariance through ``kernel_matrix_fused``); float64, and
any tensor on the CPU, take the
plain composition, as in the JAX package.  Left out of ``_fused_enabled``
(``ops/kernels.py:25-48``): the ``FUSED_MIN_N = 2048`` threshold
(``pallas_kernels.py:332``), set on a TPU; the ``GPYREG_TPU_NO_FUSED_KERNEL``
switch (:42); and the limit D < 128 (:36-41), which the TPU's gradient
kernel needs and the CUDA kernel does not (it stages D in chunks).
"""

import torch


def _fused_enabled(X, diag):
    """Dispatch gate for the kernel tile."""
    return not diag and X.dtype == torch.float32 and X.device.type == "cuda"


def sq_dist(a, b=None):
    """Pairwise squared euclidean distances, (N,D),(M,D) -> (N,M).

    The self-covariance diagonal is exactly zero (the expansion leaves
    an O(eps) residue there that Matern-1/2 amplifies) and the result is
    clamped at zero (cancellation can give tiny negatives)."""
    self_cov = b is None
    if self_cov:
        b = a
    a2 = torch.sum(a * a, dim=-1, keepdim=True)  # (N,1)
    b2 = torch.sum(b * b, dim=-1)  # (M,)
    d = a2 + b2[None, :] - 2.0 * (a @ b.T)
    if self_cov:
        d.fill_diagonal_(0.0)
    return torch.clamp(d, min=0.0)


def _safe_sqrt(d):
    """sqrt with a zero-safe gradient (the gradient of sqrt at 0 is
    inf): the double ``where`` keeps autograd finite on the diagonal of
    self-distance matrices and returns the one-sided limit 0 there."""
    pos = d > 0.0
    safe = torch.where(pos, d, torch.ones_like(d))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(d))


# --- Matern radial profiles: K = sf2 * f(t) * exp(-t), t = sqrt(deg)*r ---

_MATERN_F = {
    1: lambda t: 1.0,
    3: lambda t: 1.0 + t,
    5: lambda t: 1.0 + t * (1.0 + t / 3.0),
}


def radial_profile(base, t2, sf2, alpha):
    """Kernel value sf2 * profile(t2) from the lengthscale-scaled squared
    distance t2 (``base`` in se, m1, m3, m5, rq)."""
    if base == "se":
        return sf2 * torch.exp(-0.5 * t2)
    if base in ("m1", "m3", "m5"):
        deg = int(base[1])
        t = _safe_sqrt(float(deg) * t2)
        return sf2 * _MATERN_F[deg](t) * torch.exp(-t)
    if base == "rq":
        return sf2 * (1.0 + 0.5 * t2 / alpha) ** (-alpha)
    raise ValueError(f"Unknown kernel profile {base}")


def cov_params(base, iso, hyp_cov, X):
    """(ell, sf2, alpha) from the log-hyperparameter vector, as tensors
    on X's device and dtype (alpha is 1 but for ARD rq)."""
    D = X.shape[1]
    h = torch.as_tensor(hyp_cov, dtype=X.dtype, device=X.device)
    if iso:
        ell = torch.exp(h[0])
        sf2 = torch.exp(2.0 * h[1])
    else:
        ell = torch.exp(h[0:D])
        sf2 = torch.exp(2.0 * h[D])
    if base == "rq" and not iso:
        alpha = torch.exp(h[D + 1])
    else:
        alpha = torch.ones((), dtype=X.dtype, device=X.device)
    return ell, sf2, alpha


def kernel_matrix(cov: str, hyp_cov, X, Z=None, diag=False):
    """Evaluate the covariance kernel named by ``cov``.

    Parameters
    ----------
    cov : str
        One of 'se', 'm1', 'm3', 'm5', 'rq' and their '_iso' variants.
    hyp_cov : (cov_N,) tensor
        Log-lengthscale(s), log-outputscale (+ log-shape for 'rq').
    X : (N, D) tensor
    Z : (M, D) tensor, optional
        Cross-covariance points. If None, self-covariance.
    diag : bool
        Only the diagonal of the self-covariance (shape (N,)).

    Returns
    -------
    K : (N, N), (N, M) or (N,) tensor
    """
    iso = cov.endswith("_iso")
    base = cov[:-4] if iso else cov
    if base not in ("se", "m1", "m3", "m5", "rq") or (iso and base == "rq"):
        raise ValueError(f"Unknown covariance kind: {cov}")
    hyp_cov = torch.as_tensor(hyp_cov, dtype=X.dtype, device=X.device)
    ell, sf2, alpha = cov_params(base, iso, hyp_cov, X)

    if diag:
        return sf2 * torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)

    if _fused_enabled(X, diag):
        from .tile_kernels import KernelSelfFused, kernel_matrix_fused

        if Z is None:
            return KernelSelfFused.apply(base, iso, hyp_cov, X)
        if torch.is_grad_enabled() and (
            hyp_cov.requires_grad or X.requires_grad or Z.requires_grad
        ):
            raise NotImplementedError(
                "The cross-covariance kernel tile has no gradient; it "
                "serves predictions, which run under torch.no_grad()."
            )
        return kernel_matrix_fused(cov, hyp_cov, X, Z)

    Zs = None if Z is None else Z / ell
    return radial_profile(base, sq_dist(X / ell, Zs), sf2, alpha)


def cov_hyp_count(cov: str, D: int) -> int:
    if cov.endswith("_iso"):
        return 2
    if cov == "rq":
        return D + 2
    return D + 1
