"""The schedule and the folded contraction of the port's tile kernels
(gpyreg_tpu_torch/ops/tile_kernels.py), on the CPU.

``tile_pairs`` lists the unordered square tile pairs (I, J), I <= J, that
the CUDA kernels walk; a pair covers its tile and, off the diagonal, the
mirror tile.  ``vjp_tile_folded_ref`` is the gradient tile's contraction
over those pairs with ``Gbar_ij + Gbar_ji``.  It must equal the unfolded
``vjp_tile_ref`` for any cotangent, symmetric or not: at 1e-12 relative
in float64, and against the JAX package's Pallas gradient kernel in
interpret mode at the float32 tolerance of tests/test_torch_vjp.py (1e-4
relative per entry, scaled by max(|g|, 1)).  Inputs come from a numpy
seed; N is not a tile multiple, and a duplicated row makes t2 0 off the
diagonal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpyreg_tpu.ops import pallas_kernels as PK
from gpyreg_tpu_torch.ops import tile_kernels as TK

torch.set_num_threads(1)

COVS = ["se", "m1", "m3", "m5", "rq", "se_iso", "m1_iso", "m3_iso", "m5_iso"]
F32_RTOL = 1e-4
F64_RTOL = 1e-12


def _split(cov):
    iso = cov.endswith("_iso")
    return (cov[:-4] if iso else cov), iso


def _inputs(N, D, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    X[11] = X[2 * N // 3]  # off-diagonal t2 == 0
    G = rng.normal(size=(N, N))
    assert not np.allclose(G, G.T)
    return X, G


def _close(a, b, rtol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= rtol * max(1.0, np.max(np.abs(b)))


@pytest.mark.parametrize("T", [64, 128])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 4097])
def test_tile_pairs_cover_the_plane_once(N, T):
    pairs = TK.tile_pairs(N, T)
    nt = -(-N // T)
    assert len(pairs) == nt * (nt + 1) // 2
    assert all(0 <= i <= j < nt for i, j in pairs)
    assert sorted(i for i, j in pairs if i == j) == list(range(nt))
    count = np.zeros((N, N), dtype=np.int8)
    for i, j in pairs:
        count[i * T:(i + 1) * T, j * T:(j + 1) * T] += 1
        if i != j:
            count[j * T:(j + 1) * T, i * T:(i + 1) * T] += 1
    assert np.all(count == 1)


@pytest.mark.parametrize("grid", [1, 7, 264])
def test_tile_pairs_strided_walks_deal_out_the_schedule(grid):
    """Block b of a persistent grid of ``grid`` blocks takes pairs b,
    b + grid, ...: the blocks' walks partition the schedule."""
    for N, T in ((4097, 64), (65, 64), (1000, 128)):
        pairs = TK.tile_pairs(N, T)
        walks = [TK.tile_pairs(N, T, b, grid) for b in range(grid)]
        for b, walk in enumerate(walks):
            assert walk == pairs[b::grid]
        assert sum(len(w) for w in walks) == len(pairs)


@pytest.mark.parametrize("cov", COVS)
def test_vjp_folded_matches_unfolded_float64(cov):
    """The fold is an identity of the sum for a non-symmetric Gbar, at two
    tile sizes; N = 150 leaves a ragged last tile."""
    base, iso = _split(cov)
    X, G = _inputs(150, 5, 0)
    Xt, Gt = torch.as_tensor(X), torch.as_tensor(G)
    ref = TK.vjp_tile_ref(base, iso, Xt, Gt, 1.3, 0.7)
    for T in (64, 128):
        g = TK.vjp_tile_folded_ref(base, iso, Xt, Gt, 1.3, 0.7, T=T)
        assert g.dtype == torch.float64
        _close(g.numpy(), ref.numpy(), F64_RTOL)


@pytest.mark.parametrize("cov", COVS)
def test_vjp_folded_matches_pallas_interpret(cov, monkeypatch):
    monkeypatch.setattr(PK, "INTERPRET", True)
    base, iso = _split(cov)
    X, G = (a.astype(np.float32) for a in _inputs(320, 4, 1))
    sf2, alpha = 1.3, 0.7
    g_jax = PK._vjp_pallas(base, iso, jnp.asarray(X), jnp.asarray(G), sf2,
                           alpha, True)
    g_t = TK.vjp_tile_folded_ref(base, iso, torch.as_tensor(X),
                                 torch.as_tensor(G), sf2, alpha)
    assert g_t.dtype == torch.float32
    _close(g_t.numpy(), g_jax, F32_RTOL)
