"""The layout of the port's factor and solve (``gpyreg_tpu_torch/ops/
linalg.py``): each factor is written by the solver straight into its slot
of one stack, column-major as cuSOLVER writes it, and alpha's solve reads
the factor in place,
so a posterior build makes no copy or clone of an (N, N) matrix inside
``gpyreg.chol`` and ``gpyreg.solve`` but a retry's clone of K.  No JAX
here: the last test is marked ``cuda`` and runs on a card with

    python -m pytest --noconftest tests/test_torch_linalg_layout.py -q
"""

import numpy as np
import pytest
import torch

from gpyreg_tpu_torch.core import model as MT
from gpyreg_tpu_torch.core import nlml as NT
from gpyreg_tpu_torch.ops import linalg as TL

torch.set_num_threads(1)

# Relative to the largest entry: the upper and lower potrf variants
# round apart by about eps * a small factor of N.
FACTOR_RTOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _rel(a, b):
    return (torch.max(torch.abs(a - b)) / torch.max(torch.abs(b))).item()


def _spd_stack(B, N, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((B, N, N), generator=g, dtype=torch.float64)
    return (A @ A.mT / N + torch.eye(N, dtype=torch.float64)).to(dtype)


def _indefinite(N, neg, seed):
    """Symmetric, one eigenvalue ``-neg`` and the rest in [1, 2]."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    lam = np.concatenate([[-neg], rng.uniform(1.0, 2.0, size=N - 1)])
    return torch.tensor((Q * lam) @ Q.T)


def _nn_copies(fn, N):
    """(fn(), the ``aten::copy_`` and ``aten::clone`` calls on an (N, N)
    tensor that run inside a ``gpyreg.chol`` or ``gpyreg.solve`` span; a
    clone's own copy is the clone)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        out = fn()
    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name in ("gpyreg.chol", "gpyreg.solve")]
    assert spans
    hits = [e.name for e in events
            if e.name in ("aten::copy_", "aten::clone")
            and e.input_shapes and list(e.input_shapes[0])[-2:] == [N, N]
            and not (e.cpu_parent and e.cpu_parent.name == "aten::clone")
            and any(a <= e.time_range.start and e.time_range.end <= b
                    for a, b in spans)]
    return out, hits


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_factor_written_into_the_stack(dtype):
    B, N = 4, 48
    K = _spd_stack(B, N, dtype, 0)
    sn2 = torch.full((N,), 1e-2, dtype=dtype)
    G1 = K + torch.diag(sn2)
    L, mult = TL._jittered_cholesky_impl(K, sn2)
    assert mult.tolist() == [1.0] * B
    # One stack, each factor in its own slot with F strides.
    assert L.shape == (B, N, N) and L.mT.is_contiguous()
    size = N * N * L.element_size()
    for i in range(B):
        assert L[i].stride() == (1, N)
        assert L[i].data_ptr() == L.data_ptr() + i * size
        assert torch.all(torch.triu(L[i], 1) == 0)
    # K holds G(1), which a retry starts from.
    assert torch.equal(K, G1)
    ref = torch.linalg.cholesky(G1)
    assert _rel(L, ref) < FACTOR_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_factor_ex_is_the_stack_factorization(dtype):
    """``nlz_chain`` and ``nlz_design`` factor through ``factor_ex``: the
    same bytes, strides and status as a slot of the stack."""
    N = 48
    G = _spd_stack(1, N, dtype, 7)
    L, info = TL.factor_ex(G[0])
    assert int(info) == 0 and L.stride() == (1, N)
    L_stack, _ = TL._jittered_cholesky_impl(
        G.clone(), torch.zeros((N,), dtype=dtype))
    assert torch.equal(L, L_stack[0])
    _, info = TL.factor_ex(_indefinite(N, 0.5, 8).to(dtype))
    assert int(info) > 0


def test_posterior_build_copies_no_nn_matrix():
    N, D, S = 256, 3, 3
    spec = MT.ModelSpec(D=D, cov="se", mean="const", noise_constant=True,
                        noise_user=0, noise_rectified=False)
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.normal(size=(N, D)))
    y = torch.sin(X.sum(1, keepdim=True)) + 0.1 * torch.tensor(
        rng.normal(size=(N, 1)))
    hyp = 0.1 * rng.normal(size=(S, spec.hyp_N))
    hyp[:, spec.cov_N] = np.log(0.1)
    parts, hits = _nn_copies(lambda: NT.gp_parts(spec, hyp, X, y, None), N)
    assert parts[3].tolist() == [1.0] * S  # no escalation
    assert hits == []


def test_escalation_clones_once():
    N = 256
    sn2 = torch.full((N,), 1e-3, dtype=torch.float64)
    # The middle matrix fails at m = 1 and factors at m = 10.
    K = torch.stack([_indefinite(N, n, i)
                     for i, n in enumerate([-0.5, 5e-3, -0.5])])
    r = torch.tensor(np.random.default_rng(2).normal(size=(N, 1)))

    def build():
        L, mult = TL._jittered_cholesky_impl(K, sn2)
        return L, mult, TL.chol_solve(L, r)

    (L, mult, alpha), hits = _nn_copies(build, N)
    assert mult.tolist() == [1.0, 10.0, 1.0]
    assert hits == ["aten::clone"]
    G = K[1] + 9.0 * torch.diag(sn2)  # K holds G(1)
    assert _rel(L[1], torch.linalg.cholesky(G)) < FACTOR_RTOL[torch.float64]
    alpha_ref = torch.cholesky_solve(r, torch.linalg.cholesky(G))
    assert _rel(alpha[1], alpha_ref) < 1e-12


def test_chol_solve_matches_cholesky_solve():
    N = 64
    L = torch.linalg.cholesky(_spd_stack(3, N, torch.float64, 3))
    b = torch.randn((N, 2), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    one = TL.chol_solve(L[0], b)
    assert _rel(one, torch.cholesky_solve(b, L[0])) < 1e-12
    stack = TL.chol_solve(L, b)
    assert stack.shape == (3, N, 2)
    for i in range(3):
        assert _rel(stack[i], torch.cholesky_solve(b, L[i])) < 1e-12
    # A factor with F strides, as the port stores it, solves alike.
    LF = L[1].mT.contiguous().mT
    assert LF.stride() == (1, N)
    assert _rel(TL.chol_solve(LF, b), torch.cholesky_solve(b, L[1])) < 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_new_route_matches_old_on_card(cuda):
    """At N = 4096 in float32: the factor written into the stack and alpha
    from the two triangular solves against ``cholesky_ex`` on the
    row-major matrix and ``torch.cholesky_solve``."""
    N = 4096
    A = torch.randn((N, N), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float32).to(cuda)
    G = A @ A.mT / N + torch.eye(N, device=cuda)
    G = 0.5 * (G + G.mT)
    r = torch.randn((N, 1), generator=torch.Generator().manual_seed(6),
                    dtype=torch.float32).to(cuda)
    sn2 = torch.zeros((N,), dtype=torch.float32, device=cuda)
    L_old, info = torch.linalg.cholesky_ex(G)
    alpha_old = torch.cholesky_solve(r, L_old)
    L, mult = TL._jittered_cholesky_impl(G.clone()[None], sn2)
    alpha = TL.chol_solve(L, r)
    torch.cuda.synchronize()
    assert int(info) == 0 and mult.tolist() == [1.0]
    assert L.mT.is_contiguous() and torch.all(torch.triu(L[0], 1) == 0)
    assert _rel(L[0], L_old) < 1e-5
    assert _rel(alpha[0], alpha_old) < 1e-5
