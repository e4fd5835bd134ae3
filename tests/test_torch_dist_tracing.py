"""The spans and the copy counter of the row-sharded exact GP on the CPU:
under ``torch.profiler`` each ``gpyreg.dist.*`` phase of a fit is one
span and the hyperparameters' copy one sync; ``mesh.PEER_COPIES`` counts
every block that moves between two distinct devices, as worked out by
hand for four shards, and nothing on a mesh of one device."""

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
    # P = 4, N = 256, b = 32: 64 rows a shard, 8 panels, two a shard;
    # float64, D = 2.  Panel c0's owner o = c0 // 64; a shard s > o has
    # rows below the panel, and o too but for its last panel.
    _, got = _count(M.make_mesh(devices=FOUR), 256, 32)
    B = 8
    blocks = {
        # hyp_cov (3), X (256 x 2), mask and sW (256) from the first
        # device to the other three.
        "replicate": (4 * 3, 3 * B * (3 + 512 + 256 + 256)),
        # The (32, 32) factor of a panel to each other shard below it:
        # 3, 3, 2, 2, 1, 1, 0, 0 over the panels.
        "factor": (12, 12 * B * 32 * 32),
        # Shard s gathers the panel rows of every shard t < s below it
        # (32 columns): panel 0: 1 + 2 + 3 copies of 32, 64 and 64 rows
        # (shard 0 has 32 below); panel 1: 1 + 2, 64 rows each; panel 2:
        # 1 + 2 of 32, 32 and 64 rows; panel 3: one of 64; panel 4: one
        # of 32; none after.
        "gather": (14, B * 32 * (288 + 192 + 128 + 64 + 32)),
        # Forward: each panel's (32, 1) solution to each shard below;
        # backward: each shard's (32, 1) share to the panel's owner.
        "solves": (24, 24 * B * 32),
        # sW r and sW, (64, 1) a shard, to the three other shards; the
        # quadratic form's and the log-determinant's scalars back.
        "vectors": (12, 6 * B * 64 + 6 * B),
    }
    assert got == {"copies": sum(c for c, _ in blocks.values()),
                   "bytes": sum(n for _, n in blocks.values())}
    assert got == {"copies": 74, "bytes": 312440}


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
