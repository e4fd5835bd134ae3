"""The port's kernel tile (gpyreg_tpu_torch/ops/tile_kernels.py) against
the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the wrapper takes the plain PyTorch version; the CUDA kernel
itself is held to that version on the card (tests/test_torch_cuda.py).
Same float32 inputs from a numpy seed on both sides; tolerance 1e-5
absolute, that of tests/test_fused_kernel.py:46.  N and M are not tile
multiples.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpyreg_tpu.ops import pallas_kernels as PK
from gpyreg_tpu_torch.ops import kernels as KT
from gpyreg_tpu_torch.ops import tile_kernels as TK

torch.set_num_threads(1)

TOL = 1e-5
COVS = ["se", "m1", "m3", "m5", "rq", "se_iso", "m1_iso", "m3_iso", "m5_iso"]


def _inputs(cov, N=300, M=200, D=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    Z = rng.normal(size=(M, D)).astype(np.float32)
    n_hyp = 2 if cov.endswith("_iso") else (D + 2 if cov == "rq" else D + 1)
    hyp = (0.2 * rng.normal(size=(n_hyp,)) + 0.1).astype(np.float32)
    return X, Z, hyp


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("base", TK.PROFILES)
def test_kernel_cross_ref_matches_pallas(base, cross):
    X, Z, _ = _inputs(base)
    sf2, alpha = 1.3, 0.7
    Zs = Z if cross else X
    K_jax = np.asarray(
        PK.kernel_cross_pallas(
            base, jnp.asarray(X), jnp.asarray(Zs), sf2, alpha,
            interpret=True, zero_diag=not cross,
        )
    )
    K_t = TK.kernel_cross(
        base, torch.as_tensor(X), torch.as_tensor(Zs), sf2, alpha,
        zero_diag=not cross,
    )
    assert K_t.dtype == torch.float32 and K_t.shape == K_jax.shape
    assert np.max(np.abs(K_t.numpy() - K_jax)) < TOL


@pytest.mark.parametrize("cov", COVS)
def test_kernel_matrix_fused_matches_pallas(cov):
    X, Z, hyp = _inputs(cov, N=260, M=130, seed=1)
    for Zarg in (None, Z):
        K_jax = np.asarray(
            PK.kernel_matrix_pallas(
                cov, jnp.asarray(hyp), jnp.asarray(X),
                Z=None if Zarg is None else jnp.asarray(Zarg), interpret=True,
            )
        )
        K_t = TK.kernel_matrix_fused(
            cov, torch.as_tensor(hyp), torch.as_tensor(X),
            Z=None if Zarg is None else torch.as_tensor(Zarg),
        )
        assert np.max(np.abs(K_t.numpy() - K_jax)) < TOL


def test_cpu_path_launches_nothing_and_self_fused_has_no_backward():
    """On the CPU, ``KernelSelfFused`` runs both plain versions and
    launches nothing.  It has no backward into X, as in
    ``gpyreg_tpu/ops/pallas_kernels.py:381``; its backward into the
    hyperparameters matches autograd of the plain composition."""
    X, _, hyp = _inputs("se", N=64, seed=2)
    TK.reset_launches()
    h = torch.as_tensor(hyp).requires_grad_(True)
    Xt = torch.as_tensor(X).requires_grad_(True)
    K = TK.KernelSelfFused.apply("se", False, h, Xt)
    K_jax = np.asarray(
        PK.kernel_matrix_pallas("se", jnp.asarray(hyp), jnp.asarray(X),
                                interpret=True)
    )
    assert np.max(np.abs(K.detach().numpy() - K_jax)) < TOL
    K.sum().backward()
    assert set(TK.LAUNCHES.values()) == {0}
    assert Xt.grad is None
    h_ref = torch.as_tensor(hyp).requires_grad_(True)
    KT.kernel_matrix("se", h_ref, torch.as_tensor(X)).sum().backward()
    assert torch.max(torch.abs(h.grad - h_ref.grad)).item() < 1e-4 * max(
        1.0, torch.max(torch.abs(h_ref.grad)).item()
    )
