"""On-card checks of the port's CUDA kernel tile (``gpyreg_tpu_torch``
only; no JAX).  Each test is marked ``cuda`` and skips without a card.

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


def test_self_fused_forward_and_no_backward(cuda):
    X, _ = _inputs(200, 1, 5, 2, cuda)
    hyp = torch.tensor([0.1, -0.2, 0.3, 0.0, 0.2, 0.4], device=cuda,
                       dtype=torch.float32, requires_grad=True)
    K = TK.KernelSelfFused.apply("se", False, hyp, X)
    Xs, sf2, alpha = TK._scaled_params("se", False, hyp.detach(), X)
    ref = TK.kernel_cross_ref("se", Xs, Xs, sf2, alpha, zero_diag=True)
    assert torch.max(torch.abs(K.detach() - ref)).item() < TOL
    with pytest.raises(NotImplementedError):
        K.sum().backward()


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
    assert TK.LAUNCHES == {"self": S, "cross": 0}
    gp64 = gp_from_arrays({**meta, "dtype": "float64"}, X, y, None, hyp, "cpu")
    xs = rng.normal(size=(500, D))
    mu32, s232 = gp32.predict(xs, separate_samples=True)
    assert TK.LAUNCHES == {"self": S, "cross": S}
    mu64, s264 = gp64.predict(xs, separate_samples=True)
    assert np.max(np.abs(mu32 - mu64)) < 1e-3
    assert np.max(np.abs(s232 - s264)) < 1e-3
