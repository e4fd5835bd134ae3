"""Each count of ``portbench/work/`` against a count by hand at small
shapes."""

import pytest

from portbench.work import (cholesky, kernel_tile, kernel_vjp, nlml_grad,
                            peaks, posterior, predict)


def _potrf_ops(n):
    """Operations of the textbook right-looking Cholesky, counted as it
    runs: a square root, the column's divisions, the trailing update's
    multiply-adds of the lower triangle."""
    ops = 0
    for k in range(n):
        ops += 1 + (n - k - 1)
        m = n - k - 1
        ops += 2 * m * (m + 1) // 2
    return ops


@pytest.mark.parametrize("n", [1, 2, 5, 9])
def test_potrf_count_is_the_textbook_loop(n):
    assert cholesky.potrf(n) == pytest.approx(_potrf_ops(n))


def test_kernel_tile_counts_by_hand():
    # 4 x 3 cross at d = 2: 12 entries written, 7 rows of 2 read.
    assert kernel_tile.counts(4, 3, 2, False) == (4 * (12 + 14), 3 * 2 * 12)
    # 4 x 4 self: 16 entries written, 10 computed.
    assert kernel_tile.counts(4, 4, 2, True) == (4 * (16 + 16), 3 * 2 * 10)
    nbytes, ops = kernel_tile.counts(16384, 16384, 10, True)
    assert kernel_tile.bound_s(16384, 16384, 10, True) == pytest.approx(
        max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FP32_FLOPS_PER_S))
    # PERF.md's bound of the 16384^2 self tile: 0.3209 ms, set by bytes.
    assert kernel_tile.bound_s(16384, 16384, 10, True) * 1e3 == pytest.approx(
        0.3209, abs=5e-5)


def test_kernel_vjp_counts_by_hand():
    # n = 3, d = 2: 9 + 6 + 2 + 2 floats; 9 + 6 * (10 + 6) operations.
    assert kernel_vjp.counts(3, 2) == (4 * 19, 9 + 6 * 16)
    assert kernel_vjp.bound_s(4096, 8) * 1e3 == pytest.approx(0.0201, abs=5e-5)


def test_step_counts_by_hand():
    N, D, M, S = 6, 2, 5, 3
    tile_cross = 3 * D * N * M
    assert predict.flops(N, D, M, S) == S * (tile_cross + N * N * M + 5 * N * M)
    tile_self = 3 * D * N * (N + 1) // 2
    assert posterior.flops(N, D, S) == pytest.approx(
        S * (tile_self + _potrf_ops(N) + 2 * N * N))
    vjp = N * N + N * (N + 1) // 2 * (5 * D + 6)
    assert nlml_grad.flops(N, D) == pytest.approx(
        tile_self + _potrf_ops(N) + 2 * N * N + cholesky.potri(N) + 2 * N * N
        + vjp)
    assert cholesky.potri(N) == pytest.approx(2 * N**3 / 3 + N**2 / 2 + N / 6)
