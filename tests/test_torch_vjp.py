"""The port's gradient tile (``vjp_tile`` and its plain version
``vjp_tile_ref``, gpyreg_tpu_torch/ops/tile_kernels.py) against the JAX
package's Pallas gradient kernel in interpret mode, and against autograd
of the plain composition.

On the CPU the wrapper takes the plain version; the CUDA kernel is held
to that version on the card (tests/test_torch_cuda.py).  Same inputs from
a numpy seed on both sides: N = 320 (not a tile multiple), D = 4, a
random cotangent that is not symmetric, and a duplicated row, so t2 is 0
off the diagonal.  float32 against the Pallas kernel at 1e-4 relative per
entry, scaled by max(|g|, 1) (tests/test_fused_kernel.py:58); float64
against autograd at 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpyreg_tpu.ops import pallas_kernels as PK
from gpyreg_tpu_torch.ops import kernels as KT
from gpyreg_tpu_torch.ops import tile_kernels as TK

torch.set_num_threads(1)

COVS = ["se", "m1", "m3", "m5", "rq", "se_iso", "m1_iso", "m3_iso", "m5_iso"]
F32_RTOL = 1e-4
F64_RTOL = 1e-10


def _inputs(N=320, D=4, seed=0, dup=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    if dup:
        X[11] = X[2 * N // 3]  # off-diagonal t2 == 0
    G = rng.normal(size=(N, N))
    return X, G


def _split(cov):
    iso = cov.endswith("_iso")
    return (cov[:-4] if iso else cov), iso


def _close(a, b, rtol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= rtol * max(1.0, np.max(np.abs(b)))


@pytest.mark.parametrize("cov", COVS)
def test_vjp_tile_ref_matches_pallas_interpret(cov, monkeypatch):
    monkeypatch.setattr(PK, "INTERPRET", True)
    base, iso = _split(cov)
    X, G = (a.astype(np.float32) for a in _inputs())
    sf2, alpha = 1.3, 0.7
    g_jax = PK._vjp_pallas(base, iso, jnp.asarray(X), jnp.asarray(G), sf2,
                           alpha, True)
    TK.reset_launches()
    g_t = TK.vjp_tile(base, iso, torch.as_tensor(X), torch.as_tensor(G),
                      sf2, alpha)
    assert TK.LAUNCHES["vjp"] == 0  # CPU: the plain version
    assert g_t.dtype == torch.float32
    _close(g_t.numpy(), g_jax, F32_RTOL)


@pytest.mark.parametrize("cov", COVS)
def test_vjp_tile_ref_matches_autograd_float64(cov):
    """The gradient row is the cotangent of the log-hyperparameters of
    the plain composition ``ops.kernels.kernel_matrix``.  No duplicated
    row here: at a duplicate pair the composition's norm expansion leaves
    t2 at rounding level, which the unbounded m1 slope turns into a
    gradient term of ~1e-9 relative, where the direct form gives 0."""
    base, iso = _split(cov)
    X, G = _inputs(seed=1, dup=False)
    n_hyp = KT.cov_hyp_count(cov, X.shape[1])
    hyp = 0.2 * np.random.default_rng(2).normal(size=(n_hyp,))
    h = torch.tensor(hyp, requires_grad=True)
    Xt, Gt = torch.as_tensor(X), torch.as_tensor(G)
    (KT.kernel_matrix(cov, h, Xt) * Gt).sum().backward()
    Xs, sf2, alpha = TK._scaled_params(base, iso, torch.as_tensor(hyp), Xt)
    g = TK.vjp_tile_ref(base, iso, Xs, Gt, sf2, alpha)
    assert g.dtype == torch.float64
    _close(g.numpy(), h.grad.numpy(), F64_RTOL)


@pytest.mark.parametrize("cov", ["se", "m1", "rq", "m5_iso"])
def test_kernel_self_fused_on_cpu_matches_plain_autograd(cov):
    """``KernelSelfFused`` on CPU tensors, forward and backward, against
    autograd of the plain composition: the wiring of the custom
    Function.  X gets no gradient."""
    base, iso = _split(cov)
    X, G = _inputs(N=150, seed=3)
    hyp = 0.2 * np.random.default_rng(4).normal(
        size=(KT.cov_hyp_count(cov, X.shape[1]),))
    h = torch.tensor(hyp, requires_grad=True)
    Xt = torch.tensor(X, requires_grad=True)
    K = TK.KernelSelfFused.apply(base, iso, h, Xt)
    h_ref = torch.tensor(hyp, requires_grad=True)
    K_ref = KT.kernel_matrix(cov, h_ref, torch.as_tensor(X))
    _close(K.detach().numpy(), K_ref.detach().numpy(), 1e-12)
    Gt = torch.as_tensor(G)
    (K * Gt).sum().backward()
    (K_ref * Gt).sum().backward()
    _close(h.grad.numpy(), h_ref.grad.numpy(), F64_RTOL)
    assert Xt.grad is None


def test_radial_slope_on_axis_convention():
    """dK/dt2 is 0 at t2 == 0 for the Materns (``_dprofile``), finite for
    se and rq, and matches the Pallas module's ``_dprofile``."""
    t2 = torch.tensor([0.0, 1e-30, 0.3, 2.0], dtype=torch.float64)
    for base in TK.PROFILES:
        P = TK.radial_slope(base, t2, 1.3, 0.7)
        P_jax = PK._dprofile(base, jnp.asarray(t2.numpy()), 1.3, 0.7)
        assert torch.all(torch.isfinite(P))
        _close(P[2:].numpy(), np.asarray(P_jax)[2:], 1e-14)
        if base.startswith("m"):
            assert P[0].item() == 0.0
