"""Fused pairwise-distance + kernel tile: the CUDA kernel's wrapper and
its plain PyTorch version.

Port of the forward half of ``gpyreg_tpu/ops/pallas_kernels.py``:
``_make_kernel`` / ``_kernel_cross_pallas`` (:99-181), ``_scaled_params``
(:335-350), the ``kernel_self_fused`` forward (:353-375) and
``kernel_matrix_pallas`` (:392-412); ``_profile`` (:38-55) is
``ops.kernels.radial_profile``, shared with the plain composition.  The
tile itself is the hand-written CUDA kernel ``csrc/kernel_tile.cu``,
which computes the squared distance by direct differences (see its
header).

:func:`kernel_cross` launches the kernel for a CUDA tensor and raises on
anything the kernel does not take; for a tensor on the CPU it returns
:func:`kernel_cross_ref`, the same function in plain PyTorch (the norm
expansion of ``ops/kernels.sq_dist``).  Each launch adds one to
``LAUNCHES["self"]`` (a ``zero_diag`` build) or ``LAUNCHES["cross"]``.

Left out until the NLML-gradient slice: the one-pass backward tile
(``_dprofile`` :58-84, ``_make_vjp_kernel`` / ``_vjp_pallas``
:184-326).  :class:`KernelSelfFused` therefore raises in ``backward``.
Left out for good: the 256-row tile padding (:146-149, the kernel masks
its ragged edges), the ``INTERPRET`` switch (:35, CUDA has no
interpreter: the CPU path is the plain version) and ``FUSED_MIN_N``
(:332, a threshold set on a TPU).
"""

import torch

from ._build import kernel_tile_lib
from .kernels import cov_params, radial_profile, sq_dist

PROFILES = ("se", "m1", "m3", "m5", "rq")

# Kernel launches since the last reset_launches(): "self" counts
# self-covariance builds (zero_diag), "cross" every other build.
LAUNCHES = {"self": 0, "cross": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_cross_ref(base, Xs, Zs, sf2, alpha=1.0, zero_diag=False):
    """Plain PyTorch K(Xs, Zs) for pre-scaled inputs: ``ops.kernels``'
    norm expansion ``|x|^2 + |z|^2 - 2 x.z`` (a full-precision matmul),
    the diagonal zeroed when ``zero_diag`` (``Zs`` is ``Xs``), the clamp
    at 0, then the radial profile."""
    t2 = sq_dist(Xs, None if zero_diag else Zs)
    return radial_profile(base, t2, sf2, alpha)


def _param(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(1)


def kernel_cross(base, Xs, Zs, sf2, alpha=1.0, zero_diag=False):
    """K(Xs, Zs) = sf2 * profile(|xs - zs|^2), float32, (N, M).

    ``Xs`` (N, D) and ``Zs`` (M, D) are already divided by the
    lengthscales; ``sf2`` and ``alpha`` are floats or one-element
    tensors.  ``zero_diag`` marks a self-covariance build (``Zs`` is
    ``Xs``).  On the CPU this is :func:`kernel_cross_ref`; a CUDA tensor
    launches ``csrc/kernel_tile.cu`` on the current stream, or raises.
    """
    if Xs.device.type == "cpu":
        return kernel_cross_ref(base, Xs, Zs, sf2, alpha, zero_diag)
    if Xs.device.type != "cuda" or Zs.device != Xs.device:
        raise ValueError(
            f"kernel_cross needs both inputs on one CUDA device, got "
            f"{Xs.device} and {Zs.device}"
        )
    if base not in PROFILES:
        raise ValueError(f"Unknown kernel profile {base}")
    if Xs.dtype != torch.float32 or Zs.dtype != torch.float32:
        raise TypeError(
            f"kernel_cross takes float32, got {Xs.dtype} and {Zs.dtype}"
        )
    if Xs.ndim != 2 or Zs.ndim != 2 or Xs.shape[1] != Zs.shape[1]:
        raise ValueError(
            f"kernel_cross takes (N, D) and (M, D), got {tuple(Xs.shape)} "
            f"and {tuple(Zs.shape)}"
        )
    if not (Xs.is_contiguous() and Zs.is_contiguous()):
        raise ValueError("kernel_cross takes contiguous inputs")
    N, D = Xs.shape
    M = Zs.shape[0]
    if D == 0:
        raise ValueError("kernel_cross takes D > 0")
    lib = kernel_tile_lib()
    if N > lib.kernel_tile_max_rows():
        raise ValueError(f"kernel_cross takes at most "
                         f"{lib.kernel_tile_max_rows()} rows, got {N}")
    params = torch.cat([_param(sf2, Xs.device), _param(alpha, Xs.device)])
    out = torch.empty((N, M), dtype=torch.float32, device=Xs.device)
    if N == 0 or M == 0:
        return out
    with torch.cuda.device(Xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kernel_tile_launch(
            PROFILES.index(base),
            Xs.data_ptr(),
            Zs.data_ptr(),
            params.data_ptr(),
            out.data_ptr(),
            N,
            M,
            D,
            int(bool(zero_diag)),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"kernel_tile launch failed with CUDA error {rc}")
    LAUNCHES["self" if zero_diag else "cross"] += 1
    return out


def _scaled_params(base, iso, hyp_cov, X):
    """(X/ell, sf2, alpha) from the log-hyperparameter vector."""
    ell, sf2, alpha = cov_params(base, iso, hyp_cov, X)
    return (X / ell).contiguous(), sf2, alpha


class KernelSelfFused(torch.autograd.Function):
    """Self-covariance K(X, X) through the fused kernel, for every kernel
    family (``base`` in se, m1, m3, m5, rq; ARD or isotropic).

    The forward is the kernel-tile build with ``zero_diag``.  The one-pass
    gradient kernel (``pallas_kernels._make_vjp_kernel``) arrives with the
    NLML-gradient slice; until then ``backward`` raises rather than
    computing a plain gradient.  The serving path runs under
    ``torch.no_grad()``.
    """

    @staticmethod
    def forward(ctx, base, iso, hyp_cov, X):
        Xs, sf2, alpha = _scaled_params(base, iso, hyp_cov, X)
        return kernel_cross(base, Xs, Xs, sf2, alpha, zero_diag=True)

    @staticmethod
    def backward(ctx, K_bar):
        raise NotImplementedError(
            "The gradient of the fused self-covariance needs the one-pass "
            "VJP tile kernel (pallas_kernels._make_vjp_kernel), which is "
            "ported with the NLML-gradient slice."
        )


def kernel_matrix_fused(cov, hyp_cov, X, Z=None):
    """Fused-kernel analog of ``ops.kernels.kernel_matrix`` (full
    matrices, float32 on the card, no autograd): a self-covariance when
    ``Z`` is None, else the cross-covariance K(X, Z).  ``kernel_matrix``
    sends every float32 cross-covariance of a CUDA tensor here."""
    iso = cov.endswith("_iso")
    base = cov[:-4] if iso else cov
    ell, sf2, alpha = cov_params(base, iso, hyp_cov, X)
    Xs = (X / ell).contiguous()
    if Z is None:
        return kernel_cross(base, Xs, Xs, sf2, alpha, zero_diag=True)
    Zs = (Z / ell).contiguous()
    return kernel_cross(base, Xs, Zs, sf2, alpha, zero_diag=False)
