"""The spans and the copy counter of the row-sharded exact GP on the CPU:
under ``torch.profiler`` each ``gpyreg.dist.*`` phase of a fit is one
span and the hyperparameters' copy one sync; ``mesh.PEER_COPIES`` counts
every block that moves between two distinct devices, as worked out by
hand for four shards, and nothing on a mesh of one device;
``dist_exact.UPDATE_MACS`` counts each shard's trailing-update
multiply-adds."""

import math

import numpy as np
import pytest
import torch

from gpyreg_tpu_torch.core.model import ModelSpec
from gpyreg_tpu_torch.parallel import dist_exact as DE
from gpyreg_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

D = 2
SPEC = ModelSpec(D=D, cov="se", mean="const", noise_constant=True,
                 noise_user=0, noise_rectified=False)
PHASES = ["gpyreg.dist.build", "gpyreg.dist.cholesky",
          "gpyreg.dist.solve_lower", "gpyreg.dist.solve_upper",
          "gpyreg.dist.nlml"]
# Four distinct devices on the CPU: every tensor there reads ``cpu``, and
# the shards name their devices (``mesh.move``).
FOUR = [torch.device("cpu", i) for i in range(4)]


def _data(N):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D))
    y = np.sin(X).sum(1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    hyp = np.array([0.0] * D + [0.0, math.log(0.1), 0.0])
    return X, y, hyp


def _traced(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events()
                 if e.name.startswith("gpyreg.")]


def test_a_fit_has_each_dist_span_once_and_one_hyp_sync():
    X, y, hyp = _data(256)
    mesh = M.make_mesh(4, device="cpu")
    _, names = _traced(lambda: [DE.dist_exact_fit(SPEC, mesh, hyp, X, y,
                                                  b=32) for _ in range(2)])
    for name in PHASES:
        assert names.count(name) == 2, name
    assert names.count("gpyreg.sync.dist_hyp") == 2
    # The data is already on the mesh's device: nothing is copied.
    assert "gpyreg.sync.dist_data" not in names
    assert names.count("gpyreg.fit.factor") == 2


def test_host_data_to_another_device_is_a_data_sync():
    X, y, hyp = _data(128)
    mesh = M.make_mesh(devices=FOUR)
    _, names = _traced(lambda: DE.dist_exact_fit(SPEC, mesh, hyp, X, y,
                                                 b=32))
    assert names.count("gpyreg.sync.dist_data") == 2  # X and y


def test_predict_has_a_lower_solve_a_chunk():
    X, y, hyp = _data(256)
    post = DE.dist_exact_fit(SPEC, M.make_mesh(4, device="cpu"), hyp, X, y,
                             b=32)
    _, names = _traced(lambda: DE.dist_exact_predict(
        post, np.zeros((100, D)), chunk=64))
    assert names.count("gpyreg.dist.solve_lower") == 2
    assert names.count("gpyreg.sync.dist_hyp") == 1


def _count(mesh, N, b):
    X, y, hyp = _data(N)
    M.reset_peer_copies()
    post = DE.dist_exact_fit(SPEC, mesh, hyp, X, y, b=b)
    return post, dict(M.PEER_COPIES)


def test_peer_copies_of_a_fit_on_four_devices_as_counted_by_hand():
    # P = 4, N = 256, b = 32: 64 rows a shard, 8 panels dealt round-robin,
    # so shard s holds panels s and s + 4; float64, D = 2.  Panel p's
    # owner is shard p % 4.  A shard has rows below panel p if its panel
    # s + 4 is below it: all four for p < 4, then shards p - 3 .. 3.
    _, got = _count(M.make_mesh(devices=FOUR), 256, 32)
    B = 8
    blocks = {
        # hyp_cov (3), X (256 x 2), mask and sW (256) from the first
        # device to the other three.
        "replicate": (4 * 3, 3 * B * (3 + 512 + 256 + 256)),
        # The (32, 32) factor of a panel to each other shard with rows
        # below it: 3, 3, 3, 3, 3, 2, 1, 0 over the panels.
        "factor": (18, 18 * B * 32 * 32),
        # Every shard with rows below a panel takes the whole solved panel
        # column of every other such shard, 32 columns: n such shards make
        # n (n - 1) copies, each shard's rows to the n - 1 others.  Rows
        # below on shards 0-3: panel 0: 32 (shard 0 has panel 4 left),
        # 64, 64, 64; panel 1: 32, 32, 64, 64; panel 2: 32, 32, 32, 64;
        # panel 3: 32 each; panel 4: shards 1-3, 32 each; panel 5: shards
        # 2 and 3, 32 each; panel 6: shard 3 alone, no copy.
        "gather": (4 * 12 + 6 + 2,
                   B * 32 * (3 * (224 + 192 + 160 + 128) + 2 * 96 + 64)),
        # Forward: each panel's (32, 1) solution to each other shard with
        # rows below; backward: each such shard's (32, 1) share to the
        # panel's owner.
        "solves": (36, 36 * B * 32),
        # sW r, (64, 1) a shard, to the three other shards, and x back to
        # the first, where alpha is made; the quadratic form's and the
        # log-determinant's scalars back.
        "vectors": (12, 6 * B * 64 + 6 * B),
    }
    assert got == {"copies": sum(c for c, _ in blocks.values()),
                   "bytes": sum(n for _, n in blocks.values())}
    assert got == {"copies": 134, "bytes": 790648}


def test_the_trailing_updates_are_dealt_evenly_over_four_shards():
    """N = 4096, b = 32 on four shards: each shard's multiply-adds within
    5% of the mean, and all of them within 10% of Np^3 / 6, the lower
    triangle's."""
    X, y, hyp = _data(4096)
    DE.reset_update_macs()
    post = DE.dist_exact_fit(SPEC, M.make_mesh(4, device="cpu"), hyp,
                             X.astype(np.float32), y.astype(np.float32), b=32)
    macs = list(DE.UPDATE_MACS)
    assert post.Np == 4096 and len(macs) == 4
    mean = sum(macs) / 4
    assert max(abs(m - mean) for m in macs) <= 0.05 * mean, macs
    assert abs(sum(macs) - 4096 ** 3 / 6) <= 0.1 * 4096 ** 3 / 6, macs
    # Exactly the lower triangle with its diagonal blocks: row block g
    # takes (g - p) b^3 from each panel p < g.
    assert sum(macs) == 32 ** 3 * sum(g * (g + 1) // 2 for g in range(128))
    DE.reset_update_macs()
    assert DE.UPDATE_MACS == []


@pytest.mark.parametrize("n", [1, 4])
def test_a_mesh_of_one_device_counts_no_peer_copy(n):
    post, got = _count(M.make_mesh(n, device="cpu"), 256, 32)
    DE.dist_exact_predict(post, np.zeros((10, D)))
    assert got == {"copies": 0, "bytes": 0}
    assert M.PEER_COPIES == {"copies": 0, "bytes": 0}


def test_a_peer_copy_is_contiguous_and_counted_once():
    M.reset_peer_copies()
    a = torch.arange(12.0).reshape(3, 4)[:, 1:3]
    out = M.move(a, FOUR[1], FOUR[0])
    assert out.is_contiguous() and torch.equal(out, a)
    assert M.move(a, FOUR[0], FOUR[0]) is not None
    assert M.PEER_COPIES == {"copies": 1, "bytes": 6 * 4}
    M.reset_peer_copies()
    assert M.PEER_COPIES == {"copies": 0, "bytes": 0}


def test_the_four_devices_fit_equals_the_one_device_fit():
    X, y, hyp = _data(256)
    a = DE.dist_exact_fit(SPEC, M.make_mesh(devices=FOUR), hyp, X, y, b=32)
    b = DE.dist_exact_fit(SPEC, M.make_mesh(4, device="cpu"), hyp, X, y,
                          b=32)
    assert float(a.nlml) == float(b.nlml)
    assert torch.equal(a.alpha, b.alpha)
