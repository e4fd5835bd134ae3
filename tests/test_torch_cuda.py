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


# Shapes around the tile (64) and schedule edges: N in (1, T-1, T, T+1,
# 2T+3), N % 4 == 0 and != 0 (the TMA path and the path without it), and
# D in (1, 8, 10, 16, 17, 33) (D = 8 and 10 have their own
# instantiations; D > 16 stages more than one chunk).
EDGE_SHAPES = [(1, 1, 1), (63, 64, 8), (64, 63, 10), (65, 131, 16),
               (131, 65, 17), (128, 132, 33), (132, 128, 8), (129, 130, 10)]


def _key(kind, m):
    return kind if m % 4 == 0 else kind + "_unaligned"


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
    # Each launch is counted on the key of its store path (TMA for a row
    # stride that is a multiple of 16 bytes).
    assert TK.LAUNCHES[_key("cross", m)] == before[_key("cross", m)] + 1
    assert TK.LAUNCHES[_key("self", n)] == before[_key("self", n)] + 1
    ref = TK.kernel_cross_ref(base, X, Z, sf2, alpha)
    ref_self = TK.kernel_cross_ref(base, X, X, sf2, alpha, zero_diag=True)
    assert K.shape == (n, m) and K_self.shape == (n, n)
    assert torch.max(torch.abs(K - ref)).item() < TOL
    assert torch.max(torch.abs(K_self - ref_self)).item() < TOL
    # The self-distance diagonal is exactly zero: K_ii == sf2.
    assert torch.all(torch.diagonal(K_self) == K_self.new_tensor(sf2))


@pytest.mark.parametrize("base", TK.PROFILES)
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_kernel_at_tile_edges_and_both_paths(cuda, base, shape):
    """Cross and folded self builds at the tile edges on both store paths:
    each within TOL of the plain version, the self build bitwise
    symmetric with its diagonal exactly sf2, each launch counted on the
    key of its path."""
    n, m, d = shape
    X, Z = _inputs(n, m, d, 3, cuda)
    sf2 = torch.tensor(1.3, device=cuda)
    alpha = torch.tensor(0.7, device=cuda)
    TK.reset_launches()
    K = TK.kernel_cross(base, X, Z, sf2, alpha)
    K_self = TK.kernel_cross(base, X, X, sf2, alpha, zero_diag=True)
    torch.cuda.synchronize()
    want = dict.fromkeys(TK.LAUNCHES, 0)
    want[_key("cross", m)] += 1
    want[_key("self", n)] += 1
    assert TK.LAUNCHES == want
    ref = TK.kernel_cross_ref(base, X, Z, sf2, alpha)
    ref_self = TK.kernel_cross_ref(base, X, X, sf2, alpha, zero_diag=True)
    assert torch.max(torch.abs(K - ref)).item() < TOL
    assert torch.max(torch.abs(K_self - ref_self)).item() < TOL
    assert torch.equal(K_self, K_self.T)
    assert torch.all(torch.diagonal(K_self) == sf2)


def test_self_build_is_bitwise_symmetric_at_a_path_shape(cuda):
    """The training path's self-covariance (N = 4096, D = 8) and its
    ragged neighbour N = 4100: bitwise symmetric, diagonal exactly sf2."""
    for n in (4096, 4100):
        X, _ = _inputs(n, 1, 8, 4, cuda)
        K = TK.kernel_cross("se", X, X, 1.3, 0.7, zero_diag=True)
        assert torch.equal(K, K.T)
        assert torch.all(torch.diagonal(K) == K.new_tensor(1.3))
        ref = TK.kernel_cross_ref("se", X, X, 1.3, 0.7, zero_diag=True)
        assert torch.max(torch.abs(K - ref)).item() < TOL


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
    # The folded self build reads Xs only: Zs must be the same tensor.
    with pytest.raises(ValueError):
        TK.kernel_cross("se", X, X.clone(), 1.0, zero_diag=True)


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
    key = "vjp" if n % 4 == 0 else "vjp_unaligned"
    before = TK.LAUNCHES[key]
    g = TK.vjp_tile(base, iso, X, G, 1.3, 0.7)
    g2 = TK.vjp_tile(base, iso, X, G, 1.3, 0.7)
    torch.cuda.synchronize()
    assert TK.LAUNCHES[key] == before + 2
    ref = TK.vjp_tile_ref(base, iso, X, G, 1.3, 0.7)
    width = 2 if iso else (d + 2 if base == "rq" else d + 1)
    assert g.shape == (width,) and g.dtype == torch.float32
    assert torch.equal(g, g2)
    scale = max(1.0, torch.max(torch.abs(ref)).item())
    assert torch.max(torch.abs(g - ref)).item() < VJP_RTOL * scale


@pytest.mark.parametrize("cov", ["se", "m1", "m3", "m5", "rq", "se_iso",
                                 "m1_iso"])
@pytest.mark.parametrize("shape", [(1, 1), (63, 8), (64, 10), (65, 16),
                                   (131, 17), (132, 33), (128, 8), (129, 10)])
def test_vjp_kernel_at_tile_edges_and_both_paths(cuda, cov, shape):
    """The folded gradient at the tile and schedule edges, on the TMA
    path (N % 4 == 0) and the path without it: a non-symmetric cotangent
    and its transpose give the same row, bit for bit, within VJP_RTOL of
    the plain version and of the plain folded contraction; two launches
    agree bit for bit; each launch is counted on its path's key."""
    n, d = shape
    iso = cov.endswith("_iso")
    base = cov[:-4] if iso else cov
    X, _ = _inputs(n, 1, d, 11, cuda)
    if n > 8:
        X[7] = X[n // 2]
    G = torch.as_tensor(np.random.default_rng(12).normal(size=(n, n)),
                        dtype=torch.float32, device=cuda)
    TK.reset_launches()
    g = TK.vjp_tile(base, iso, X, G, 1.3, 0.7)
    g2 = TK.vjp_tile(base, iso, X, G, 1.3, 0.7)
    gt_ = TK.vjp_tile(base, iso, X, G.T.contiguous().T, 1.3, 0.7)
    torch.cuda.synchronize()
    want = dict.fromkeys(TK.LAUNCHES, 0)
    want["vjp" if n % 4 == 0 else "vjp_unaligned"] = 3
    assert TK.LAUNCHES == want
    assert torch.equal(g, g2)
    ref = TK.vjp_tile_ref(base, iso, X, G, 1.3, 0.7)
    folded = TK.vjp_tile_folded_ref(base, iso, X, G, 1.3, 0.7)
    scale = max(1.0, torch.max(torch.abs(ref)).item())
    assert torch.max(torch.abs(g - ref)).item() < VJP_RTOL * scale
    assert torch.max(torch.abs(g - folded)).item() < VJP_RTOL * scale
    # G.T.contiguous().T is G's values in column-major order: the wrapper
    # reads it as the row-major G^T, and the fold gives the same sums.
    assert torch.max(torch.abs(gt_ - ref)).item() < VJP_RTOL * scale


def test_vjp_kernel_takes_an_unaligned_cotangent_without_tma(cuda):
    """A cotangent whose base is not 16-byte aligned goes to the path
    without TMA, whatever N, and agrees bit for bit with the TMA path on
    the same values (the same pairs, sums in the same order)."""
    n, d = 256, 8
    X, _ = _inputs(n, 1, d, 13, cuda)
    flat = torch.as_tensor(np.random.default_rng(14).normal(size=n * n + 1),
                           dtype=torch.float32, device=cuda)
    G_off = flat[1:].view(n, n)
    assert G_off.data_ptr() % 16 != 0
    TK.reset_launches()
    g_off = TK.vjp_tile("se", False, X, G_off, 1.3, 0.7)
    g = TK.vjp_tile("se", False, X, G_off.clone(), 1.3, 0.7)
    assert TK.LAUNCHES["vjp_unaligned"] == 1 and TK.LAUNCHES["vjp"] == 1
    assert torch.equal(g, g_off)


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
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0), "self": B,
                           "vjp": B}
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
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0), "self": S}
    gp64 = gp_from_arrays({**meta, "dtype": "float64"}, X, y, None, hyp, "cpu")
    xs = rng.normal(size=(500, D))
    mu32, s232 = gp32.predict(xs, separate_samples=True)
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0), "self": S,
                           "cross": S}
    mu64, s264 = gp64.predict(xs, separate_samples=True)
    assert np.max(np.abs(mu32 - mu64)) < 1e-3
    assert np.max(np.abs(s232 - s264)) < 1e-3


def test_fit_on_card_runs_through_both_kernels(cuda):
    """A small float32 ``GP.fit`` (MAP only) on the card, with no
    ``device`` argument: the design rows launch the kernel tile, every
    L-BFGS evaluation the kernel tile and the gradient tile, all on the
    TMA paths (N % 4 == 0), and the MAP objective agrees with the same
    fit in float64 on the CPU to 1e-3 * max(1, |f|)."""
    import gpyreg_tpu_torch as gt

    rng = np.random.default_rng(9)
    N, D, init_N, opts_N = 512, 3, 32, 2
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.3 * rng.normal(size=(N, 1))
    options = {"n_samples": 0, "init_N": init_N, "opts_N": opts_N,
               "f32_noise_floor": True}

    def fit(**kw):
        g = gt.GP(D, gt.covariance_functions.SquaredExponential(),
                  gt.mean_functions.ConstantMean(),
                  gt.noise_functions.GaussianNoise(constant_add=True), **kw)
        np.random.seed(3)
        return (g,) + g.fit(X, y, options=dict(options))

    TK.reset_launches()
    g, hyp, res, samples = fit(dtype=np.float32)
    launches = dict(TK.LAUNCHES)
    assert g.device.type == "cuda" and samples is None
    assert g.posteriors[0].alpha.is_cuda
    restarts = g.fit_report["restarts"]
    assert len(restarts) == opts_N
    assert launches["vjp"] >= sum(r.nit for r in restarts) > 0
    # design rows + evaluations + the value at each restart's end + the
    # posterior
    assert launches["self"] == init_N + launches["vjp"] + opts_N + 1
    assert launches["cross"] == 0
    assert not any(v for k, v in launches.items() if k.endswith("_unaligned"))
    assert np.isfinite(res.fun) and res.fun < g.fit_report["design_best"]
    floor = g._f32_noise_floor(g.lower_bounds, g.upper_bounds, D + 1, options)
    assert floor[D + 1] > g.lower_bounds[D + 1] and hyp[0, D + 1] >= floor[D + 1]
    _, _, res64, _ = fit(dtype=np.float64, device="cpu")
    assert abs(res.fun - res64.fun) < 1e-3 * max(1.0, abs(res64.fun))


def test_sampling_fit_on_card_runs_through_the_kernel_tile(cuda, monkeypatch):
    """A float32 ``GP.fit`` with hyperposterior sampling on the card
    (N = 1024, defaults but for the design and chain lengths): the
    samples lie in the fit's bounds, each kept sample's f_vals +
    log_priors is its log posterior recomputed on the card, and every
    density of the chain launched the kernel tile on the TMA path (at
    least ``n_evals`` launches in the sampling window, the rest jitter
    retries), while the chain launches no gradient tile."""
    import gpyreg_tpu_torch as gt
    from gpyreg_tpu_torch.inference import sampling

    rng = np.random.default_rng(4)
    N, D = 1024, 3
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.3 * rng.normal(size=(N, 1))
    window = {}
    run = sampling.run_sampling

    def counted(*args, **kw):
        TK.reset_launches()
        out = run(*args, **kw)
        torch.cuda.synchronize()
        window.update(TK.LAUNCHES)
        return out

    monkeypatch.setattr(sampling, "run_sampling", counted)
    g = gt.GP(D, gt.covariance_functions.SquaredExponential(),
              gt.mean_functions.ConstantMean(),
              gt.noise_functions.GaussianNoise(constant_add=True), dtype=np.float32)
    np.random.seed(1)
    TK.reset_launches()
    hyp, res, sr = g.fit(X, y, options={"n_samples": 6, "thin": 2, "burn": 6,
                                        "init_N": 32, "opts_N": 1})
    assert hyp.shape == (6, D + 3) and res is not None
    assert np.all(hyp >= g.lower_bounds) and np.all(hyp <= g.upper_bounds)
    fns, args = g._obj_args()
    for s, f, lp in zip(sr["samples"], sr["f_vals"][:, 0], sr["log_priors"]):
        ref = float(fns["log_post_chain_raw"](s, *args))
        assert abs(f + lp - ref) <= 1e-5 * max(1.0, abs(ref))
    assert window["self"] >= sr["n_evals"] > 0
    assert window["vjp"] == 0 and window["cross"] == 0
    assert not any(v for k, v in window.items() if k.endswith("_unaligned"))
    assert all(bool(torch.all(torch.isfinite(p.alpha))) for p in g.posteriors)


@pytest.mark.parametrize("sampler", ["mala", "hmc"])
def test_gradient_sampler_fit_on_card_launches_the_gradient_tile(cuda, monkeypatch,
                                                                 sampler):
    """A float32 ``GP.fit`` with the MALA or HMC sampler on the card
    (N = 512, a short chain): every value-and-gradient call of the chain
    launches the kernel tile and then the gradient tile once, on the TMA
    paths (the Cholesky's jitter retries refactor without a launch), and
    each kept sample's f_vals + log_priors is its log posterior recomputed
    on the card within 1e-5 relative."""
    import gpyreg_tpu_torch as gt
    from gpyreg_tpu_torch.inference import hmc, mala

    module = mala if sampler == "mala" else hmc
    run = module.sample
    calls, window = [], {}

    def counted(log_f, *args, **kw):
        def f(x, *a):
            calls.append(1)
            return log_f(x, *a)

        TK.reset_launches()
        out = run(f, *args, **kw)
        torch.cuda.synchronize()
        window.update(TK.LAUNCHES)
        return out

    monkeypatch.setattr(module, "sample", counted)
    rng = np.random.default_rng(5)
    N, D = 512, 3
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.3 * rng.normal(size=(N, 1))
    g = gt.GP(D, gt.covariance_functions.SquaredExponential(),
              gt.mean_functions.ConstantMean(),
              gt.noise_functions.GaussianNoise(constant_add=True), dtype=np.float32)
    np.random.seed(2)
    hyp, res, sr = g.fit(X, y, options={"sampler": sampler, "n_samples": 4,
                                        "thin": 1, "burn": 4, "hmc_steps": 3,
                                        "init_N": 32, "opts_N": 1})
    # MALA: (4 + 4) x (D + 3) steps; HMC: 8 iterations x 3 leapfrog points.
    steps = 8 * (D + 3) if sampler == "mala" else 8 * 3
    assert hyp.shape == (4, D + 3) and res is not None
    assert np.all(hyp >= g.lower_bounds) and np.all(hyp <= g.upper_bounds)
    assert 0.0 <= sr["accept_rate"] <= 1.0
    assert 1 < len(calls) <= 1 + steps
    assert window["vjp"] == len(calls) and window["self"] == len(calls)
    assert window["cross"] == 0
    assert not any(v for k, v in window.items() if k.endswith("_unaligned"))
    fns, args = g._obj_args()
    for s, f, lp in zip(sr["samples"], sr["f_vals"][:, 0], sr["log_priors"]):
        ref = float(fns["log_post_chain_raw"](s, *args))
        assert abs(f + lp - ref) <= 1e-5 * max(1.0, abs(ref))
    assert all(bool(torch.all(torch.isfinite(p.alpha))) for p in g.posteriors)


def test_gp_sample_on_card_launches_one_cross_column_per_posterior(cuda):
    """``GP.sample`` on a float32 card GP: each density builds K(X, x) of
    each posterior with the kernel tile on one column, which is the path
    without TMA (M = 1), and nothing else launches; the samples are
    finite and in bounds, and at beta 0 the density is ``predict``'s
    mixture mean."""
    from gpyreg_tpu_torch.convert import gp_from_arrays

    rng = np.random.default_rng(6)
    N, D, S = 512, 3, 3
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    hyp = np.zeros((S, D + 3))
    hyp[:, D + 1] = np.log(0.1)
    hyp += 0.05 * rng.normal(size=hyp.shape)
    meta = {"D": D, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0], "dtype": "float32"}
    g = gp_from_arrays(meta, X, y, None, hyp, cuda)
    TK.reset_launches()
    samples = g.sample(20, key=3)
    launches = dict(TK.LAUNCHES)
    assert samples.shape == (20, D) and np.all(np.isfinite(samples))
    lb = X.min(axis=0) - 10 * (X.max(axis=0) - X.min(axis=0))
    ub = X.max(axis=0) + 10 * (X.max(axis=0) - X.min(axis=0))
    assert np.all(samples >= lb) and np.all(samples <= ub)
    n = launches["cross_unaligned"]
    assert n > 0 and n % S == 0
    assert launches == {**dict.fromkeys(TK.LAUNCHES, 0), "cross_unaligned": n}
    mu_s2 = g._mixture_mean_variance_fn(compute_var=False)
    m, _ = mu_s2(torch.tensor(samples[0]))
    mu, _ = g.predict(samples[:1])
    assert abs(float(m) - mu[0, 0]) <= 1e-4 * max(1.0, abs(mu[0, 0]))


def _serving_gp(cuda, N=512, D=3, S=3, seed=7):
    """A float32 card GP and the same GP in float64 on the CPU."""
    from gpyreg_tpu_torch.convert import gp_from_arrays

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    hyp = np.zeros((S, D + 3))
    hyp[:, D + 1] = np.log(0.1)
    hyp += 0.05 * rng.normal(size=hyp.shape)
    meta = {"D": D, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0]}
    g32 = gp_from_arrays({**meta, "dtype": "float32"}, X, y, None, hyp, cuda)
    g64 = gp_from_arrays({**meta, "dtype": "float64"}, X, y, None, hyp, "cpu")
    return g32, g64, rng


def test_rank_one_update_on_card_matches_cpu(cuda):
    """Two single-point updates of a float32 card GP: each launches one
    N x 1 cross-covariance a posterior on the path without TMA and
    nothing else (no rebuild), and the grown GP predicts as the port's
    float64 CPU GP after the same updates."""
    g32, g64, rng = _serving_gp(cuda)
    S = g32.posteriors.size
    for _ in range(2):
        x = rng.normal(size=(1, 3))
        y = np.sum(np.sin(x), axis=1, keepdims=True)
        TK.reset_launches()
        g32.update(X_new=x, y_new=y)
        assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0),
                               "cross_unaligned": S}
        g64.update(X_new=x, y_new=y)
    assert g32.posteriors[0].L.shape == (514, 514)
    xs = rng.normal(size=(200, 3))
    mu32, s232 = g32.predict(xs, separate_samples=True)
    mu64, s264 = g64.predict(xs, separate_samples=True)
    assert np.max(np.abs(mu32 - mu64)) < 1e-3
    assert np.max(np.abs(s232 - s264)) < 1e-3


def test_predict_full_on_card_launches_self_and_cross(cuda):
    """``predict_full`` at M = 64 test points: one M x M self- and one
    N x M cross-covariance a posterior, both on the TMA paths, and the
    covariance agrees with the float64 CPU GP's."""
    g32, g64, rng = _serving_gp(cuda)
    S = g32.posteriors.size
    xs = rng.normal(size=(64, 3))
    TK.reset_launches()
    mu32, c32 = g32.predict_full(xs)
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0), "self": S,
                           "cross": S}
    mu64, c64 = g64.predict_full(xs)
    assert c32.shape == (64, 64, S)
    assert np.max(np.abs(mu32 - mu64)) < 1e-3
    assert np.max(np.abs(c32 - c64)) < 1e-3


def test_panel_matvec_on_card_builds_every_panel_with_the_tile(cuda):
    """The CG operator's matvec on the card: one kernel-tile cross a
    (row_chunk, N) panel (N % 4 == 0: the TMA store), and the product
    agrees with the plain float64 matvec on the CPU."""
    from gpyreg_tpu_torch.core.model import ModelSpec
    from gpyreg_tpu_torch.ops import iterative as IT

    rng = np.random.default_rng(11)
    N, D, B, rc = 1024, 4, 9, 256
    X = rng.normal(size=(N, D))
    V = rng.normal(size=(N, B))
    hyp_cov = np.concatenate([0.2 * rng.normal(size=D), [0.1]])
    sn2 = np.full((N,), 0.05)
    spec = ModelSpec(D=D, cov="se", mean="const", noise_constant=True,
                     noise_user=0, noise_rectified=False)
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)  # noqa: E731
    TK.reset_launches()
    with torch.no_grad():
        out = IT._panel_matvec(spec, t32(hyp_cov), t32(X), t32(V), t32(sn2), rc)
    torch.cuda.synchronize()
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0), "cross": N // rc}
    ref = IT._panel_matvec(spec, torch.as_tensor(hyp_cov), torch.as_tensor(X),
                           torch.as_tensor(V), torch.as_tensor(sn2), rc)
    scale = torch.max(torch.abs(ref)).item()
    assert torch.max(torch.abs(out.cpu().double() - ref)).item() < 1e-4 * scale


def test_cg_nlml_and_predict_on_card_match_cpu(cuda):
    """``cg_nlml`` with its gradient on the card, padded (N = 1000 in
    panels of 256): every forward panel of the CG and Lanczos passes is a
    kernel-tile cross (the surrogate takes the plain composition and
    launches nothing), the value and gradient agree with the float64 CPU
    estimate from the same probes, and ``cg_predict`` at 64 points with
    its 1000 x 64 cross agrees with the float64 CPU prediction."""
    from gpyreg_tpu_torch.core.model import ModelSpec
    from gpyreg_tpu_torch.ops import iterative as IT

    rng = np.random.default_rng(12)
    N, D = 1000, 4
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.5 * rng.normal(size=(N, 1))
    hyp = np.concatenate([0.2 * rng.normal(size=D), [0.1], [np.log(0.5)], [0.1]])
    spec = ModelSpec(D=D, cov="se", mean="const", noise_constant=True,
                     noise_user=0, noise_rectified=False)
    kw = dict(key=0, compute_grad=True, tol=1e-5, row_chunk=256, n_probes=4,
              n_lanczos=12, return_sol=True)
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)  # noqa: E731
    probes = IT.make_probes(0, (1024, 4), torch.float64, "cpu")
    real = IT.make_probes
    IT.make_probes = lambda s, shape, dtype, device: probes.to(dtype=dtype,
                                                                device=device)
    try:
        TK.reset_launches()
        v32, g32, _, it32 = IT.cg_nlml(spec, hyp, t32(X), t32(y), **kw)
        launches = dict(TK.LAUNCHES)
        v64, g64, _, _ = IT.cg_nlml(spec, hyp, torch.as_tensor(X),
                                    torch.as_tensor(y), **kw)
    finally:
        IT.make_probes = real
    assert launches == {**dict.fromkeys(TK.LAUNCHES, 0),
                        "cross": 4 * (it32 + 12)}
    assert abs(v32 - v64) < 1e-3 * abs(v64)
    assert np.max(np.abs(g32 - g64)) < 1e-2 * max(1.0, np.max(np.abs(g64)))
    xs = rng.normal(size=(64, D))
    TK.reset_launches()
    mu32, s32, info = IT.cg_predict(spec, hyp, t32(X), t32(y), None, t32(xs),
                                    compute_var=True, tol=1e-5, row_chunk=256,
                                    test_chunk=64)
    n_mv = info["alpha_iters"] + info["var_iters"]
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0),
                           "cross": 4 * n_mv + 1}
    mu64, s64, _ = IT.cg_predict(spec, hyp, torch.as_tensor(X), torch.as_tensor(y),
                                 None, torch.as_tensor(xs), compute_var=True,
                                 tol=1e-9, row_chunk=256, test_chunk=64)
    assert np.max(np.abs(mu32 - mu64)) < 1e-3 and np.max(np.abs(s32 - s64)) < 1e-3


def test_outwarp_nlml_gradient_on_card_goes_through_the_gradient_tile(cuda):
    """A warped NLML gradient on the card: one self build and one
    gradient-tile launch a lane, and the float32 gradient (the warp's
    entries from autograd) agrees with the float64 CPU gradient."""
    from gpyreg_tpu_torch.core.model import ModelSpec
    from gpyreg_tpu_torch.core.nlml import get_fns

    rng = np.random.default_rng(13)
    N, D, B = 512, 3, 2
    X = rng.uniform(-3, 3, size=(N, D))
    y = -0.5 * np.sum(X**2, axis=1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    spec = ModelSpec(D=D, cov="se", mean="const", noise_constant=True,
                     noise_user=0, noise_rectified=False, outwarp="negpowc1")
    hyp = 0.05 * rng.normal(size=(B, spec.hyp_N))
    hyp[:, D + 1] += np.log(0.3)
    hyp[:, D + 3] += -3.0  # the threshold inside the data
    fns = get_fns(spec, False, False)
    TK.reset_launches()
    v32, g32 = fns["nlz_grad"](hyp, torch.as_tensor(X, dtype=torch.float32,
                                                    device=cuda),
                               torch.as_tensor(y, dtype=torch.float32,
                                               device=cuda))
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0), "self": B, "vjp": B}
    v64, g64 = fns["nlz_grad"](hyp, torch.as_tensor(X), torch.as_tensor(y))
    scale = torch.clamp(torch.abs(g64), min=1.0)
    assert torch.max(torch.abs(g32.cpu() - g64) / scale).item() < 1e-2
    assert torch.all(g64[:, -2:] != 0)


def _mesh_data(N, D, M, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.3 * rng.normal(size=(N, 1))
    return X, y, rng.normal(size=(M, D))


def _dist_exact_against_plain(devices):
    """dist_exact_fit and dist_exact_predict in float32 on a mesh over
    ``devices`` against the plain path (float64, a mesh of as many shards
    on the CPU): one kernel-tile cross a shard for the build, one a shard
    and chunk for predict, each slab on its shard's device with zeros
    right of each row's own global column (``shard_rows``)."""
    from gpyreg_tpu_torch.core.model import ModelSpec
    from gpyreg_tpu_torch.parallel import dist_exact as DE
    from gpyreg_tpu_torch.parallel import mesh as PM

    N, D, M, b = 1000, 4, 100, 64
    X, y, xs = _mesh_data(N, D, M, 14)
    spec = ModelSpec(D=D, cov="se", mean="const", noise_constant=True,
                     noise_user=0, noise_rectified=False)
    hyp = np.concatenate([np.zeros(D), [0.0], [np.log(0.5)], [0.1]])
    mesh = PM.make_mesh(devices=devices)
    P = mesh.size
    TK.reset_launches()
    post = DE.dist_exact_fit(spec, mesh, hyp, X.astype(np.float32),
                             y.astype(np.float32), b=b)
    torch.cuda.synchronize()
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0), "cross": P}
    rows = post.Np // P
    for i, slab in enumerate(post.slabs):
        assert slab.device == mesh.devices[i] and slab.shape == (rows, post.Np)
        cols = torch.arange(post.Np, device=slab.device)
        upper = cols[None, :] > post.shard_rows(i).to(slab.device)[:, None]
        assert torch.all(slab[upper] == 0)
    TK.reset_launches()
    mu32, s232 = DE.dist_exact_predict(post, xs)
    chunks = -(-M // min(1024, -(-M // 64) * 64))
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0),
                           "cross": P * chunks}
    plain = DE.dist_exact_fit(spec, PM.make_mesh(P, device="cpu"), hyp, X, y,
                              b=b)
    mu64, s264 = DE.dist_exact_predict(plain, xs)
    assert abs(float(post.nlml) - float(plain.nlml)) < 1e-4 * abs(float(plain.nlml))
    assert np.max(np.abs(mu32 - mu64)) < 1e-3
    assert np.max(np.abs(s232 - s264)) < 1e-3


def test_dist_exact_on_four_shards_of_one_card(cuda):
    _dist_exact_against_plain([torch.device("cuda", 0)] * 4)


def test_dist_exact_across_the_cards_of_the_host(cuda):
    """The first launches of the kernel tile on a device other than
    cuda:0, where the host has two cards or more (2 or 4 of them)."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two CUDA devices")
    _dist_exact_against_plain([torch.device("cuda", i)
                               for i in range(4 if count >= 4 else 2)])


def _mesh_paths_against_single(cuda, devices):
    """sharded_nlml_grad (7 lanes padded to the mesh: 7 self and 7
    gradient tiles), sharded_cg_weights (one cross a panel a matvec) and
    GP(mesh=...).predict (one cross a shard and sample) on a mesh over
    ``devices`` (2 or 4 shards), against the single-device paths on
    ``cuda``."""
    import gpyreg_tpu_torch as gt
    from gpyreg_tpu_torch.core.model import ModelSpec
    from gpyreg_tpu_torch.core.nlml import get_fns
    from gpyreg_tpu_torch.ops import iterative as IT
    from gpyreg_tpu_torch.parallel import mesh as PM

    mesh = PM.make_mesh(devices=devices)
    P = mesh.size
    N, D = 1024, 4
    X, y, xs = _mesh_data(N, D, 96, 15)
    spec = ModelSpec(D=D, cov="se", mean="const", noise_constant=True,
                     noise_user=0, noise_rectified=False)
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)  # noqa: E731
    hyps = 0.05 * np.random.default_rng(16).normal(size=(7, spec.hyp_N))
    hyps[:, D + 1] += np.log(0.3)
    TK.reset_launches()
    v, g = PM.sharded_nlml_grad(spec, mesh, hyps, t32(X), t32(y))
    torch.cuda.synchronize()
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0), "self": 7, "vjp": 7}
    v1, g1 = get_fns(spec, False, False)["nlz_grad"](hyps, t32(X), t32(y))
    assert torch.max(torch.abs(v - v1)).item() <= 1e-6 * torch.max(torch.abs(v1)).item()
    assert torch.max(torch.abs(g - g1)).item() <= 1e-6 * max(
        1.0, torch.max(torch.abs(g1)).item())

    TK.reset_launches()
    alpha, res, iters = PM.sharded_cg_weights(spec, mesh, hyps[0], t32(X[:1000]),
                                              t32(y[:1000]), tol=1e-5,
                                              max_iter=300)
    torch.cuda.synchronize()
    # 1000 rows over P shards: one panel of 1000 / P rows a shard.
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0),
                           "cross": P * iters}
    with torch.no_grad():
        a1 = IT.cg_posterior_weights(spec, hyps[0], t32(X[:1000]),
                                     t32(y[:1000]), None, tol=1e-5,
                                     max_iter=300)[0]
    assert float(res.max()) <= 1e-5
    assert torch.max(torch.abs(alpha - a1)).item() < 1e-3 * max(
        1.0, torch.max(torch.abs(a1)).item())

    def gp(m):
        g_ = gt.GP(D, gt.covariance_functions.SquaredExponential(),
                   gt.mean_functions.ConstantMean(),
                   gt.noise_functions.GaussianNoise(constant_add=True),
                   dtype=np.float32, mesh=m)
        g_.update(X_new=X, y_new=y, hyp=hyps[:2])
        return g_

    g1_, gm = gp(None), gp(mesh)
    TK.reset_launches()
    mu_m, s2_m = gm.predict(xs, separate_samples=True)
    assert TK.LAUNCHES == {**dict.fromkeys(TK.LAUNCHES, 0), "cross": 2 * P}
    mu_1, s2_1 = g1_.predict(xs, separate_samples=True)
    assert np.max(np.abs(mu_m - mu_1)) < 1e-5 * max(1.0, np.max(np.abs(mu_1)))
    assert np.max(np.abs(s2_m - s2_1)) < 1e-5


def test_mesh_paths_on_four_shards_of_one_card(cuda):
    _mesh_paths_against_single(cuda, [torch.device("cuda", 0)] * 4)


def test_mesh_paths_across_the_cards_of_the_host(cuda):
    """The same over 2 or 4 cards (a power of two: each shard's shapes
    stay on the TMA paths), where the host has two or more."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two CUDA devices")
    _mesh_paths_against_single(cuda, [torch.device("cuda", i)
                                      for i in range(4 if count >= 4 else 2)])
