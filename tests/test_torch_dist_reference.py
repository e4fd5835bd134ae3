"""The port's row-sharded exact GP (``parallel.dist_exact``) against the
benchmark's float64 tile reference (``portbench/reference/dist_gp.py``)
on the CPU, and that reference against the dense one
(``portbench/reference/gp.py``).

The port runs on ``make_mesh(4, device="cpu")``, four shards; the
reference deals its tiles to four CPU devices, with tiles small enough
that the factorization, the substitutions and the predictive variance
cross many tiles, the last ragged.  Data: x ~ N(0, I_10), y = sum(sin x)
+ 0.1 N(0, 1), the vector the benchmark's base (log ell 0, log sf 0,
log sn log 0.1, mean 0) plus 0.05 N(0, 1), as ``dist131k``'s.  This file
imports no JAX."""

import math

import numpy as np
import pytest
import torch

from gpyreg_tpu_torch.core.model import ModelSpec
from gpyreg_tpu_torch.parallel import dist_exact as DE
from gpyreg_tpu_torch.parallel.mesh import make_mesh
from portbench.reference import dist_gp
from portbench.reference import gp as dense

torch.set_num_threads(1)

D = 10
DEVICES = [torch.device("cpu")] * 4
SPEC = ModelSpec(D=D, cov="se", mean="const", noise_constant=True,
                 noise_user=0, noise_rectified=False)

# float64: the same numbers by two algorithms (block-row panels against
# tile columns), each rounding at 1e-16; B's condition number at these
# sizes is below 1e3, so 1e-10 leaves room of 1e3 or more.
TOL64 = 1e-10
# float32: the port rounds at 6e-8 and its error grows with B's
# condition number (below 1e3 here); the NLML, a sum over N rows, and
# alpha stay within 1e-5 and 1e-4 (the benchmark's own float32 readings
# at N=256 are near 1e-7 and 1e-6).
TOL32 = {"nlml": 1e-5, "alpha": 1e-4, "mean": 1e-4, "var": 1e-4}


def _data(N, seed=0, M=64):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    y = np.sin(X).sum(1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    hyp = np.array([0.0] * D + [0.0, math.log(0.1), 0.0])
    hyp = hyp + 0.05 * rng.normal(size=hyp.shape)
    xs = rng.normal(size=(M, D))
    return X, y, hyp, xs


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("N,b,tile", [(1000, 32, 128), (256, 64, 48)])
def test_dist_exact_equals_the_tile_reference(N, b, tile, dtype):
    X, y, hyp, xs = _data(N)
    Xc, yc = X.astype(dtype), y.astype(dtype)
    post = DE.dist_exact_fit(SPEC, make_mesh(4, device="cpu"), hyp, Xc, yc,
                             b=b)
    # The reference reads the numbers the port computes with.
    ref = dist_gp.TileFactor(hyp, Xc.astype(np.float64),
                             yc.astype(np.float64), "float64", DEVICES,
                             tile=tile)
    alpha = post.alpha.double().numpy()[:, 0]
    assert post.Np >= N and np.all(alpha[N:] == 0.0)
    mu, s2 = DE.dist_exact_predict(post, xs.astype(dtype))
    rmu, rs2 = ref.predict(xs.astype(dtype).astype(np.float64))
    tol = TOL32 if dtype == np.float32 else dict.fromkeys(TOL32, TOL64)
    assert abs(float(post.nlml) - ref.nlml) <= tol["nlml"] * abs(ref.nlml)
    assert _rel(alpha[:N], ref.alpha) <= tol["alpha"]
    assert _rel(mu, rmu) <= tol["mean"]
    assert _rel(s2, rs2) <= tol["var"]


def test_the_tile_reference_equals_the_dense_reference():
    # N = 257 in tiles of 64: four full tiles and a ragged one of one row.
    N = 257
    X, y, hyp, xs = _data(N, seed=3)
    tiles = dist_gp.TileFactor(hyp, X, y, dense.F64, DEVICES, tile=64)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    value, _ = dense.nlml_grad(t(hyp), t(X), t(y), dense.F64)
    fac = dense.Factor(t(hyp), t(X), t(y), dense.F64)
    assert fac.mult == 1.0
    mu, s2 = dense.predict(fac, t(X), t(xs), dense.F64)
    tmu, ts2 = tiles.predict(xs)
    # Both in float64, B's condition number near 1e2: 1e-12 is 1e2 above
    # the rounding of either.
    assert abs(tiles.nlml - float(value)) <= 1e-12 * abs(float(value))
    assert _rel(tiles.alpha, fac.alpha[:, 0].numpy()) <= 1e-12
    assert _rel(tmu, mu.numpy()) <= 1e-12
    assert _rel(ts2, s2.numpy()) <= 1e-12


def test_the_tile_reference_sets_tf32_itself():
    seen = []
    orig = dist_gp._Prec.mm

    def spy(self, a, b):
        seen.append((self.name, torch.backends.cuda.matmul.allow_tf32))
        return orig(self, a, b)

    X, y, hyp, _ = _data(64)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dist_gp._Prec.mm = spy
        dist_gp.TileFactor(hyp, X, y, "float64", DEVICES, tile=32)
        dist_gp.TileFactor(hyp, X, y, dense.TF32, DEVICES, tile=32)
    finally:
        dist_gp._Prec.mm = orig
        torch.backends.cuda.matmul.allow_tf32 = False
    assert {s for s in seen if s[0] == "float64"} == {("float64", False)}
    assert {s for s in seen if s[0] == "tf32"} == {("tf32", True)}
    assert torch.backends.cuda.matmul.allow_tf32 is False
