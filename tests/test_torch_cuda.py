"""On-card checks of the port's CUDA kernels, the kernel tile and its
gradient tile, and of the gradient path through them
(``gpyreg_tpu_torch`` only; no JAX).  Each test is marked ``cuda`` and
skips without a card.

On a machine with a card and without JAX, run them without the suite's
conftest (which starts JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gpyreg_tpu_torch.ops import tile_kernels as TK

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# float32 kernel (direct differences) vs the plain norm-expansion
# composition: the expansion's cancellation is ~eps32 * (|x|^2 + |z|^2)
# in t2, far below this bound at these input scales.
TOL = 1e-5
# Gradient tile vs its plain version, per entry, scaled by
# max(|g_plain|, 1): the bound of tests/test_fused_kernel.py:58.
VJP_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, m, d, seed, device):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32)
    Z = torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32)
    return X.to(device), Z.to(device)


@pytest.mark.parametrize("base", TK.PROFILES)
@pytest.mark.parametrize(
    "shape", [(300, 200, 4), (1000, 777, 10), (65, 129, 17), (70, 90, 130)]
)
def test_kernel_matches_plain(cuda, base, shape):
    n, m, d = shape
    X, Z = _inputs(n, m, d, 0, cuda)
    sf2, alpha = 1.3, 0.7
    before = dict(TK.LAUNCHES)
    K = TK.kernel_cross(base, X, Z, sf2, alpha)
    K_self = TK.kernel_cross(base, X, X, sf2, alpha, zero_diag=True)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["cross"] == before["cross"] + 1
    assert TK.LAUNCHES["self"] == before["self"] + 1
    ref = TK.kernel_cross_ref(base, X, Z, sf2, alpha)
    ref_self = TK.kernel_cross_ref(base, X, X, sf2, alpha, zero_diag=True)
    assert K.shape == (n, m) and K_self.shape == (n, n)
    assert torch.max(torch.abs(K - ref)).item() < TOL
    assert torch.max(torch.abs(K_self - ref_self)).item() < TOL
    # The self-distance diagonal is exactly zero: K_ii == sf2.
    assert torch.all(torch.diagonal(K_self) == K_self.new_tensor(sf2))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    X, Z = _inputs(64, 32, 4, 1, cuda)
    with pytest.raises(TypeError):
        TK.kernel_cross("se", X.double(), Z.double(), 1.0)
    with pytest.raises(ValueError):
        TK.kernel_cross("se", X.T, Z, 1.0)
    with pytest.raises(ValueError):
        TK.kernel_cross("se", X, Z.cpu(), 1.0)
    empty = torch.zeros((8, 0), device=cuda)
    with pytest.raises(ValueError):
        TK.kernel_cross("se", empty, empty, 1.0)


def test_self_fused_backward_matches_plain(cuda):
    """The fused self-covariance on the card: forward against the plain
    version, and its backward (the gradient tile, one launch) against
    autograd of the plain composition in float64 on the CPU."""
    from gpyreg_tpu_torch.ops.kernels import kernel_matrix

    X, _ = _inputs(200, 1, 5, 2, cuda)
    hyp = torch.tensor([0.1, -0.2, 0.3, 0.0, 0.2, 0.4], device=cuda,
                       dtype=torch.float32, requires_grad=True)
    K = TK.KernelSelfFused.apply("se", False, hyp, X)
    Xs, sf2, alpha = TK._scaled_params("se", False, hyp.detach(), X)
    ref = TK.kernel_cross_ref("se", Xs, Xs, sf2, alpha, zero_diag=True)
    assert torch.max(torch.abs(K.detach() - ref)).item() < TOL
    W = torch.as_tensor(np.random.default_rng(4).normal(size=(200, 200)),
                        dtype=torch.float32, device=cuda)
    before = TK.LAUNCHES["vjp"]
    (K * W).sum().backward()
    assert TK.LAUNCHES["vjp"] == before + 1
    h64 = hyp.detach().cpu().double().requires_grad_(True)
    (kernel_matrix("se", h64, X.cpu().double()) * W.cpu().double()).sum().backward()
    g64 = h64.grad
    err = torch.max(torch.abs(hyp.grad.cpu().double() - g64)).item()
    assert err < VJP_RTOL * max(1.0, torch.max(torch.abs(g64)).item())


@pytest.mark.parametrize("cov", ["se", "m1", "m3", "m5", "rq", "se_iso",
                                 "m1_iso", "m3_iso", "m5_iso"])
@pytest.mark.parametrize("shape", [(300, 4), (1000, 10), (65, 17), (130, 130)])
def test_vjp_kernel_matches_plain(cuda, cov, shape):
    """The gradient tile against its plain version on the card, with a
    random, non-symmetric cotangent and a duplicated row; two launches
    agree bit for bit (fixed-order reduction, no atomics)."""
    n, d = shape
    iso = cov.endswith("_iso")
    base = cov[:-4] if iso else cov
    X, _ = _inputs(n, 1, d, 5, cuda)
    X[7] = X[n // 2]
    G = torch.as_tensor(np.random.default_rng(6).normal(size=(n, n)),
                        dtype=torch.float32, device=cuda)
    before = TK.LAUNCHES["vjp"]
    g = TK.vjp_tile(base, iso, X, G, 1.3, 0.7)
    g2 = TK.vjp_tile(base, iso, X, G, 1.3, 0.7)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["vjp"] == before + 2
    ref = TK.vjp_tile_ref(base, iso, X, G, 1.3, 0.7)
    width = 2 if iso else (d + 2 if base == "rq" else d + 1)
    assert g.shape == (width,) and g.dtype == torch.float32
    assert torch.equal(g, g2)
    scale = max(1.0, torch.max(torch.abs(ref)).item())
    assert torch.max(torch.abs(g - ref)).item() < VJP_RTOL * scale


def test_vjp_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    X, _ = _inputs(64, 1, 4, 1, cuda)
    G = torch.zeros((64, 64), device=cuda)
    with pytest.raises(TypeError):
        TK.vjp_tile("se", False, X.double(), G.double(), 1.0)
    with pytest.raises(ValueError):
        TK.vjp_tile("se", False, X, G[:, :32], 1.0)
    with pytest.raises(ValueError):
        strided = torch.zeros((128, 128), device=cuda)[::2, ::2]
        TK.vjp_tile("se", False, X, strided, 1.0)
    with pytest.raises(ValueError):
        TK.vjp_tile("rq", True, X, G, 1.0)
    with pytest.raises(ValueError):
        TK.vjp_tile("se", False, X, G.cpu(), 1.0)


def test_vjp_kernel_reads_a_transposed_cotangent_as_it_lies(cuda):
    """A column-major cotangent (``torch.cholesky_inverse`` returns one)
    is read without a copy: the sums are symmetric in (i, j), so G^T
    gives G's gradient, bit for bit, and the plain version agrees."""
    X, _ = _inputs(700, 1, 6, 8, cuda)
    G = torch.as_tensor(np.random.default_rng(9).normal(size=(700, 700)),
                        dtype=torch.float32, device=cuda)
    for base, iso in (("se", False), ("rq", False), ("m1", True)):
        g = TK.vjp_tile(base, iso, X, G, 1.3, 0.7)
        gt_ = TK.vjp_tile(base, iso, X, G.T, 1.3, 0.7)
        assert torch.equal(g, gt_)
        ref = TK.vjp_tile_ref(base, iso, X, G.T, 1.3, 0.7)
        scale = max(1.0, torch.max(torch.abs(ref)).item())
        assert torch.max(torch.abs(gt_ - ref)).item() < VJP_RTOL * scale


def test_nlml_gradient_on_card_matches_cpu(cuda):
    """A float32 NLML gradient on the card goes through both kernels and
    agrees with the float64 gradient on the CPU, lane by lane."""
    from gpyreg_tpu_torch.core.model import ModelSpec
    from gpyreg_tpu_torch.core.nlml import get_fns

    rng = np.random.default_rng(7)
    N, D, B = 512, 3, 3
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    hyp = 0.05 * rng.normal(size=(B, D + 3))
    hyp[:, D + 1] += np.log(0.1)
    spec = ModelSpec(D=D, cov="se", mean="const", noise_constant=True,
                     noise_user=0, noise_rectified=False)
    fns = get_fns(spec, False, False)
    TK.reset_launches()
    v32, g32 = fns["nlz_grad"](hyp, torch.as_tensor(X, dtype=torch.float32,
                                                    device=cuda),
                               torch.as_tensor(y, dtype=torch.float32,
                                               device=cuda))
    assert TK.LAUNCHES == {"self": B, "cross": 0, "vjp": B}
    v64, g64 = fns["nlz_grad"](hyp, torch.as_tensor(X), torch.as_tensor(y))
    assert g32.shape == (B, D + 3) and g32.dtype == torch.float64
    scale = torch.clamp(torch.abs(g64), min=1.0)
    assert torch.max(torch.abs(g32.cpu() - g64) / scale).item() < 1e-2
    assert torch.max(torch.abs(v32.cpu().double() - v64)).item() < 1e-2 * max(
        1.0, torch.max(torch.abs(v64)).item())


def test_gp_on_card_matches_cpu(cuda):
    """A small float32 GP served on the card agrees with the same GP in
    float64 on the CPU, and its default path (no ``pallas_predict``)
    builds both covariances with the kernel tile."""
    from gpyreg_tpu_torch.convert import gp_from_arrays

    rng = np.random.default_rng(3)
    N, D, S = 256, 3, 2
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    hyp = np.zeros((S, D + 3))
    hyp[:, D + 1] = np.log(0.1)
    hyp += 0.05 * rng.normal(size=hyp.shape)
    meta = {"D": D, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0]}
    TK.reset_launches()
    gp32 = gp_from_arrays({**meta, "dtype": "float32"}, X, y, None, hyp, cuda)
    assert TK.LAUNCHES == {"self": S, "cross": 0, "vjp": 0}
    gp64 = gp_from_arrays({**meta, "dtype": "float64"}, X, y, None, hyp, "cpu")
    xs = rng.normal(size=(500, D))
    mu32, s232 = gp32.predict(xs, separate_samples=True)
    assert TK.LAUNCHES == {"self": S, "cross": S, "vjp": 0}
    mu64, s264 = gp64.predict(xs, separate_samples=True)
    assert np.max(np.abs(mu32 - mu64)) < 1e-3
    assert np.max(np.abs(s232 - s264)) < 1e-3
