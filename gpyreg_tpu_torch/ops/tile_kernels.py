"""Fused pairwise-distance + kernel tile and its one-pass gradient: the
CUDA kernels' wrappers and their plain PyTorch versions.

Port of ``gpyreg_tpu/ops/pallas_kernels.py``: ``_make_kernel`` /
``_kernel_cross_pallas`` (:99-181), ``_dprofile`` (:58-84),
``_make_vjp_kernel`` / ``_vjp_pallas`` (:184-326), ``_scaled_params``
(:335-350), ``kernel_self_fused`` with its forward and backward
(:353-381) and ``kernel_matrix_pallas`` (:392-412); ``_profile`` (:38-55)
is ``ops.kernels.radial_profile``, shared with the plain composition.
The forward tile is the hand-written CUDA kernel ``csrc/kernel_tile.cu``;
the gradient tile is ``csrc/kernel_vjp.cu``.  Both compute squared
distances by direct differences (see their headers).

:func:`kernel_cross` and :func:`vjp_tile` launch their kernel for a CUDA
tensor and raise on anything the kernel does not take; for a tensor on
the CPU they return :func:`kernel_cross_ref` and :func:`vjp_tile_ref`,
the same functions in plain PyTorch.  Each launch adds one to
``LAUNCHES["self"]`` (a ``zero_diag`` build), ``LAUNCHES["cross"]`` or
``LAUNCHES["vjp"]``.

Left out for good: the 256-row tile padding (:146-149, :289-294; the
kernels mask their ragged edges), the ``INTERPRET`` switch (:35, CUDA has
no interpreter: the CPU path is the plain version), ``FUSED_MIN_N``
(:332, a threshold set on a TPU), the (8, 128) output block of the
gradient (:264-277, a TPU layout) and the ``se_kernel_fused`` alias
(:387-389).
"""

import torch

from ._build import kernel_tile_lib, kernel_vjp_lib
from .kernels import cov_params, radial_profile, sq_dist

PROFILES = ("se", "m1", "m3", "m5", "rq")

# Kernel launches since the last reset_launches(): "self" counts
# self-covariance builds (zero_diag), "cross" every other build, "vjp"
# the gradient contractions.
LAUNCHES = {"self": 0, "cross": 0, "vjp": 0}


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


def radial_slope(base, t2, sf2, alpha):
    """P = dK/dt2 of ``sf2 * profile(t2)``, with ``_dprofile``'s on-axis
    convention: the Matern slopes are 0 where t2 == 0, off the diagonal
    too (an m1 slope is infinite there and would give 0 * inf)."""
    if base == "se":
        return -0.5 * sf2 * torch.exp(-0.5 * t2)
    if base in ("m1", "m3", "m5"):
        deg = float(base[1])
        pos = t2 > 0.0
        t = torch.sqrt(deg * torch.where(pos, t2, torch.ones_like(t2)))
        em = torch.exp(-t)
        if base == "m1":
            val = -sf2 * em * (deg / 2.0) / t
        elif base == "m3":
            val = -sf2 * em * (deg / 2.0)
        else:
            val = -sf2 * em * (1.0 + t) * (deg / 6.0)
        return torch.where(pos, val, torch.zeros_like(val))
    if base == "rq":
        return -0.5 * sf2 * (1.0 + 0.5 * t2 / alpha) ** (-alpha - 1.0)
    raise ValueError(f"Unknown kernel profile {base}")


def _direct_sq_dist(Xs):
    """Pairwise squared distances of the rows of ``Xs`` as the kernels
    sum them: (x_k - z_k)^2 added over k in order, exactly 0 between
    equal rows."""
    t2 = torch.zeros((Xs.shape[0],) * 2, dtype=Xs.dtype, device=Xs.device)
    for k in range(Xs.shape[1]):
        d = Xs[:, k, None] - Xs[None, :, k]
        t2.addcmul_(d, d)
    return t2


def vjp_tile_ref(base, iso, Xs, Gbar, sf2, alpha=1.0):
    """Plain PyTorch gradient row of the self-covariance: the cotangent
    of ``hyp_cov`` for ``K = sf2 * profile(|xs_i - xs_j|^2)`` given
    ``Gbar = dL/dK``.  With P = dK/dt2 and E = -2 Gbar P:
    ``[sum E t2]`` (iso) or ``[sum_ij E_ij (xs_ik - xs_jk)^2]_k`` (ARD),
    then ``2 sum Gbar K``, then for rq ``sum Gbar K (t2/(2M) - alpha
    log M)``, M = 1 + t2/(2 alpha).  Direct differences, as the kernel
    takes them; full (N, N) temporaries, one dimension at a time."""
    sf2 = torch.as_tensor(sf2, dtype=Xs.dtype, device=Xs.device)
    alpha = torch.as_tensor(alpha, dtype=Xs.dtype, device=Xs.device)
    t2 = _direct_sq_dist(Xs)
    GK = Gbar * radial_profile(base, t2, sf2, alpha)
    E = -2.0 * Gbar * radial_slope(base, t2, sf2, alpha)
    if iso:
        parts = [torch.sum(E * t2)]
    else:
        parts = []
        for k in range(Xs.shape[1]):
            d = Xs[:, k, None] - Xs[None, :, k]
            parts.append(torch.sum(E * d * d))
    del E
    parts.append(2.0 * torch.sum(GK))
    if base == "rq":
        M = 1.0 + 0.5 * t2 / alpha
        parts.append(torch.sum(GK * (0.5 * t2 / M - alpha * torch.log(M))))
    return torch.stack(parts)


def vjp_tile(base, iso, Xs, Gbar, sf2, alpha=1.0):
    """The gradient row of :func:`vjp_tile_ref`, in ``Gbar``'s dtype.

    ``Xs`` (N, D) is already divided by the lengthscales; ``Gbar``
    (N, N) is any matrix (not assumed symmetric).  On the CPU this is
    :func:`vjp_tile_ref`; a CUDA tensor launches ``csrc/kernel_vjp.cu``
    (the contraction, then a fixed-order float64 sum of its per-block
    partials) on the current stream, or raises.

    Every term is symmetric in (i, j): t2_ij and t2_ji are the same
    float, summed in the same order.  So ``Gbar`` and its transpose give
    the same gradient, and a column-major ``Gbar`` (what
    ``torch.cholesky_inverse`` returns on the card) is read as the
    row-major transpose it lies in, without a 1 GB copy at N = 16384.
    """
    if Xs.device.type == "cpu" and Gbar.device.type == "cpu":
        return vjp_tile_ref(base, iso, Xs, Gbar, sf2, alpha)
    if Xs.device.type != "cuda" or Gbar.device != Xs.device:
        raise ValueError(
            f"vjp_tile needs both inputs on one CUDA device, got "
            f"{Xs.device} and {Gbar.device}"
        )
    if base not in PROFILES or (iso and base == "rq"):
        raise ValueError(f"Unknown kernel profile {base} (iso={iso})")
    if Xs.dtype != torch.float32 or Gbar.dtype != torch.float32:
        raise TypeError(
            f"vjp_tile takes float32, got {Xs.dtype} and {Gbar.dtype}"
        )
    N = Xs.shape[0]
    if Xs.ndim != 2 or Gbar.shape != (N, N):
        raise ValueError(
            f"vjp_tile takes (N, D) and (N, N), got {tuple(Xs.shape)} and "
            f"{tuple(Gbar.shape)}"
        )
    if not Gbar.is_contiguous() and Gbar.mT.is_contiguous():
        Gbar = Gbar.mT
    if not (Xs.is_contiguous() and Gbar.is_contiguous()):
        raise ValueError("vjp_tile takes a contiguous Xs, and a Gbar that "
                         "is contiguous or the transpose of a contiguous "
                         "matrix")
    D = Xs.shape[1]
    if D == 0:
        raise ValueError("vjp_tile takes D > 0")
    lib = kernel_vjp_lib()
    if N > lib.kernel_vjp_max_rows():
        raise ValueError(f"vjp_tile takes at most {lib.kernel_vjp_max_rows()} "
                         f"rows, got {N}")
    prof = PROFILES.index(base)
    width = lib.kernel_vjp_width(prof, int(bool(iso)), D)
    if N == 0:
        return torch.zeros((width,), dtype=torch.float32, device=Xs.device)
    params = torch.cat([_param(sf2, Xs.device), _param(alpha, Xs.device)])
    partials = torch.empty((lib.kernel_vjp_blocks(N), width),
                           dtype=torch.float64, device=Xs.device)
    out = torch.empty((width,), dtype=torch.float64, device=Xs.device)
    with torch.cuda.device(Xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kernel_vjp_launch(
            prof,
            int(bool(iso)),
            Xs.data_ptr(),
            Gbar.data_ptr(),
            params.data_ptr(),
            partials.data_ptr(),
            out.data_ptr(),
            N,
            D,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"kernel_vjp launch failed with CUDA error {rc}")
    LAUNCHES["vjp"] += 1
    return out.to(torch.float32)


def _scaled_params(base, iso, hyp_cov, X):
    """(X/ell, sf2, alpha) from the log-hyperparameter vector."""
    ell, sf2, alpha = cov_params(base, iso, hyp_cov, X)
    return (X / ell).contiguous(), sf2, alpha


class KernelSelfFused(torch.autograd.Function):
    """Self-covariance K(X, X) through the fused kernels, for every kernel
    family (``base`` in se, m1, m3, m5, rq; ARD or isotropic).

    The forward is the kernel-tile build with ``zero_diag``; it keeps
    ``X / ell``, ``sf2`` and ``alpha``, not K.  The backward contracts
    the cotangent of K in one pass with :func:`vjp_tile` (the gradient
    kernel on the card, its plain version on the CPU) and returns the
    cotangent of ``hyp_cov``.  ``X`` gets no gradient, as in
    ``gpyreg_tpu/ops/pallas_kernels.py:366,381``: fitting never
    differentiates through the training inputs.
    """

    @staticmethod
    def forward(ctx, base, iso, hyp_cov, X):
        Xs, sf2, alpha = _scaled_params(base, iso, hyp_cov, X)
        ctx.base, ctx.iso = base, iso
        ctx.save_for_backward(Xs, sf2, alpha)
        return kernel_cross(base, Xs, Xs, sf2, alpha, zero_diag=True)

    @staticmethod
    def backward(ctx, K_bar):
        Xs, sf2, alpha = ctx.saved_tensors
        if not (K_bar.is_contiguous() or K_bar.mT.is_contiguous()):
            K_bar = K_bar.contiguous()
        g = vjp_tile(ctx.base, ctx.iso, Xs, K_bar, sf2, alpha)
        return None, None, g.to(Xs.dtype), None


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
