"""Matrix-free iterative GP inference (conjugate gradients).

Port of ``gpyreg_tpu/ops/iterative.py``: ``_panel_matvec`` (:64-92),
``_cg`` (:95-149), ``pivoted_cholesky`` (:152-190),
``woodbury_preconditioner`` (:193-218), ``_pad_rows`` /
``_pad_panel_batch`` (:221-258), ``lanczos_tridiag`` (:261-300),
``slq_logdet`` (:303-335), ``cg_nlml`` / ``_cg_nlml_impl`` (:338-512),
``cg_log_post_raw`` (:530-597), ``fit_cg`` (:600-700),
``cg_posterior_weights`` (:703-732) and ``cg_predict`` with its solve
(:735-877).

The kernel matrix is never materialized: a matvec builds one
(row_chunk, N) panel of K at a time, multiplies it into the block of
vectors and drops it, so the working set is O(row_chunk * N).  On that
operator: CG solves against (K + sn2 I), the posterior weights and the
predictive moments, and the BBMM training objective (Gardner et al.
2018, arXiv:1809.11165): the quadratic term from CG, 0.5 logdet by
stochastic Lanczos quadrature and the gradient from the Hutchinson trace
estimator, all sharing one block of Rademacher probes.

Dispatch: every forward panel is ``core.model.cov_matrix`` of the panel
against all rows, so on a float32 CUDA tensor the kernel tile builds it
(``ops/kernels._fused_enabled``, the port's one dispatch rule); the
product ``Kp @ V`` stays ``torch.matmul``, as JAX computes it outside the
Pallas kernel (:84).  The one differentiated pass, the gradient's
surrogate, takes the plain composition (``kernel_matrix_plain``), as JAX
keeps its XLA build there (:41-47, :488-510): it is built and
differentiated one panel at a time, each panel's backward before the next
panel's forward, which is what the JAX package's checkpointed panel map
does (:87-90), so no (N, N) graph ever exists.

Randomness: the probes are Rademacher draws from a ``torch.Generator`` on
the data's device seeded from an integer (:func:`make_probes`), where the
JAX package draws a Rademacher block (N_padded, n_probes) from a random
key (:473); the same seed gives the same probes on every call (common
random numbers), as the same key does in JAX.  The ``key`` arguments of
the JAX functions are that integer seed here.

Loops run on the host: CG checks its stopping rule (every column's
relative residual below ``tol``, or ``max_iter``, JAX's rule) once an
iteration, one sync a matvec; a solve that stops at ``max_iter`` reports
its iterations and residual.

Left out, being TPU-only: ``_cross_pallas_ok`` (:33-61) with its
``GPYREG_TPU_NO_FUSED_KERNEL`` switch and its D < 128 limit (the port's
dispatch is ``ops/kernels._fused_enabled``); the compiled, cached
wrappers ``_cg_nlml_fn`` and ``_cg_solve_fn`` (:514-527,
:734-760) and ``cg_log_post_raw``'s cache (:529), which keep compiled
XLA programs identity-stable.
"""

import math

import numpy as np
import torch

from ..core.model import ModelSpec, cov_matrix, mean_value, noise_variance
from .kernels import kernel_matrix_plain


def make_probes(seed, shape, dtype, device):
    """A block of Rademacher probes (entries +-1) of ``shape``, drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    bits = torch.randint(0, 2, tuple(shape), generator=gen, device=device)
    return (2 * bits - 1).to(dtype)


def _panel_matvec(spec: ModelSpec, hyp_cov, X, V, sn2_vec, row_chunk, Z=None):
    """(K + diag(sn2)) @ V without materializing K; ``sn2_vec`` None
    leaves out the diagonal term.  X (N, D), V (N, B).  Forward only.
    With ``Z`` (M, D) the panels are K(X, Z), V is (M, B) and the result
    (N, B): a shard's rows of the product (``sn2_vec`` None)."""
    N = X.shape[0]
    Z = X if Z is None else Z
    out = torch.empty((N, V.shape[1]), dtype=V.dtype, device=V.device)
    for start in range(0, N, row_chunk):
        Kp = cov_matrix(spec, hyp_cov, X[start : start + row_chunk], Z=Z)
        out[start : start + row_chunk] = Kp @ V
        del Kp
    if sn2_vec is None:
        return out
    return out + sn2_vec[:, None] * V


def _operator(spec, hyp_cov, X, sn2_vec, row_chunk, mask):
    """V -> A V for A = K + diag(sn2); with the padding ``mask`` (1 on
    real rows, 0 on padded ones) the padded block is diag(sn2) with its
    kernel rows and columns cut away, [[A, 0], [0, I]] for unit padded
    noise."""
    if mask is None:
        return lambda V: _panel_matvec(spec, hyp_cov, X, V, sn2_vec, row_chunk)
    m = mask[:, None]

    def mv(V):
        out = _panel_matvec(spec, hyp_cov, X, V * m, None, row_chunk)
        return out * m + sn2_vec[:, None] * V

    return mv


def _cg(matvec, B, tol, max_iter, precond=None, x0=None):
    """Batched (preconditioned) conjugate gradients for A X = B, B (N,
    nrhs).

    Runs until every column's relative residual ||r|| / ||b|| is below
    ``tol`` or ``max_iter`` iterations; a converged column is frozen (its
    step lengths are 0).  ``precond`` applies M^{-1}; ``x0`` warm-starts
    from a nearby solve's solution (Lin et al. 2024, arXiv:2405.18457),
    with the stopping rule still relative to ||B||.  Returns (X,
    relative residuals (nrhs,), iterations)."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    tol = torch.as_tensor(tol, dtype=B.dtype, device=B.device)
    if x0 is None:
        X = torch.zeros_like(B)
        R = B
    else:
        X = x0
        R = B - matvec(x0)
    Z = precond(R)
    P = Z
    b_norm2 = torch.sum(B * B, dim=0)
    floor = torch.clamp(b_norm2, min=1e-30)
    thresh = tol**2 * floor
    rz = torch.sum(R * Z, dim=0)
    rs = torch.sum(R * R, dim=0)
    one = torch.ones((), dtype=B.dtype, device=B.device)
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    i = 0
    while i < max_iter and bool(torch.any(rs > thresh)):
        AP = matvec(P)
        denom = torch.sum(P * AP, dim=0)
        active = rs > thresh
        alpha = torch.where(
            active, rz / torch.where(denom > 0, denom, one), zero)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = precond(R)
        rz_new = torch.sum(R * Z, dim=0)
        rs = torch.sum(R * R, dim=0)
        beta = torch.where(
            active, rz_new / torch.where(rz != 0, rz, one), zero)
        P = Z + beta[None, :] * P
        rz = rz_new
        i += 1
    return X, torch.sqrt(rs / floor), i


def pivoted_cholesky(spec: ModelSpec, hyp_cov, X, rank: int, mask=None):
    """Partial pivoted Cholesky Lk (N, rank) of the kernel matrix, K ~=
    Lk Lk^T, from ``rank`` kernel columns built on the fly (the BBMM
    preconditioner, Gardner et al. 2018 §3.2; Harbrecht et al. 2012).
    The pivot stays on the device: no sync a column."""
    N = X.shape[0]
    d = cov_matrix(spec, hyp_cov, X, diag=True)
    if mask is not None:
        d = d * mask
    Lk = torch.zeros((N, rank), dtype=X.dtype, device=X.device)
    tiny = torch.finfo(X.dtype).tiny
    for j in range(rank):
        i = torch.argmax(d).reshape(1)
        xi = X.index_select(0, i)
        col = cov_matrix(spec, hyp_cov, X, Z=xi)[:, 0]
        col = col - Lk @ Lk.index_select(0, i)[0]
        piv = torch.sqrt(torch.clamp(d.index_select(0, i)[0], min=tiny))
        newcol = col / piv
        if mask is not None:
            newcol = newcol * mask
        Lk[:, j] = newcol
        d = torch.clamp(d - newcol**2, min=0.0).index_fill(0, i, 0.0)
    return Lk


def woodbury_preconditioner(Lk, sn2_vec):
    """M^{-1} apply for M = Lk Lk^T + diag(sn2) via Woodbury:
    M^{-1} v = D^{-1} v - D^{-1} Lk (I_k + Lk^T D^{-1} Lk)^{-1} Lk^T D^{-1} v,
    D = diag(sn2), the k x k core factored once."""
    Dinv = 1.0 / sn2_vec[:, None]
    DiL = Lk * Dinv
    k = Lk.shape[1]
    core = torch.eye(k, dtype=Lk.dtype, device=Lk.device) + Lk.T @ DiL
    C = torch.linalg.cholesky(core)

    def apply(v):
        Div = v * Dinv
        t = Lk.T @ Div
        t = torch.linalg.solve_triangular(C, t, upper=False)
        t = torch.linalg.solve_triangular(C.T, t, upper=True)
        return Div - DiL @ t

    return apply


def _pad_rows(X, row_chunk):
    """X padded to a whole number of ``row_chunk`` rows by repeating its
    last row; returns (X_padded, N)."""
    N = X.shape[0]
    Np = -(-N // row_chunk) * row_chunk
    if Np == N:
        return X, N
    return torch.cat([X, X[-1:].expand((Np - N,) + tuple(X.shape[1:]))]), N


def _pad_panel_batch(X, y, s2, row_chunk):
    """Mask-pad ``(X, y[, s2])`` to a whole number of ``row_chunk``
    panels, the one construction every matrix-free entry point shares:
    padded rows repeat the last X row with y = 0 and s2 = 1, so that under
    the ``n_real`` row mask the padded operator is [[A, 0], [0, I]] and
    the quadratic term, the log-determinant (log 1 = 0 a padded row) and
    the trace estimator stay exact.  Returns ``(Xp, yp, s2p, n_real)``,
    ``n_real`` None when no padding was needed."""
    Xp, N = _pad_rows(X, row_chunk)
    if Xp.shape[0] == N:
        return X, y, s2, None
    pad = Xp.shape[0] - N
    kw = {"dtype": X.dtype, "device": X.device}
    yp = torch.cat([y, torch.zeros((pad, 1), **kw)])
    s2p = None if s2 is None else torch.cat([s2, torch.ones((pad, 1), **kw)])
    return Xp, yp, s2p, N


def lanczos_tridiag(matvec, Z, n_steps: int):
    """Batched Lanczos tridiagonalization with full reorthogonalization.

    ``Z`` (N, P): one probe a column.  ``n_steps`` three-term recurrences
    a probe, one batched matvec a step; returns the tridiagonals'
    coefficients, alphas (steps, P) and betas (steps - 1, P).  The basis
    starts zero, so the reorthogonalization ignores rows not yet written;
    the last step writes the last row after its only use (JAX's
    indexing, :289-292)."""
    N, P = Z.shape
    norms = torch.sqrt(torch.sum(Z * Z, dim=0))
    Q0 = Z / norms[None, :]
    basis = torch.zeros((n_steps, N, P), dtype=Z.dtype, device=Z.device)
    basis[0] = Q0
    q_prev, q = torch.zeros_like(Q0), Q0
    beta_prev = torch.zeros((P,), dtype=Z.dtype, device=Z.device)
    one = torch.ones((), dtype=Z.dtype, device=Z.device)
    alphas, betas = [], []
    for j in range(n_steps):
        w = matvec(q)
        alpha = torch.sum(q * w, dim=0)
        w = w - alpha[None, :] * q - beta_prev[None, :] * q_prev
        coeffs = torch.einsum("knp,np->kp", basis, w)
        w = w - torch.einsum("knp,kp->np", basis, coeffs)
        beta = torch.sqrt(torch.clamp(torch.sum(w * w, dim=0), min=0.0))
        safe = torch.where(beta > 0, beta, one)
        q_next = torch.where(beta[None, :] > 0, w / safe[None, :],
                             torch.zeros_like(w))
        basis[min(j + 1, n_steps - 1)] = q_next
        q_prev, q, beta_prev = q, q_next, beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def slq_logdet(matvec, N: int, key, dtype, n_probes: int = 8,
               n_lanczos: int = 32, probes=None, device=None):
    """log det(A) by stochastic Lanczos quadrature: Rademacher probes
    (``probes`` (N, n_probes), else drawn from seed ``key`` on
    ``device``), each probe's Gauss quadrature from the eigenpairs of its
    Lanczos tridiagonal, logdet ~= (N/P) sum_i sum_k tau_ik^2
    log(theta_ik) with tau the eigenvectors' first components.  The P
    tridiagonals go through one batched ``eigh``; a tridiagonal with a
    non-finite entry gives NaN, as in JAX, where ``torch.linalg.eigh``
    would raise."""
    if probes is None:
        probes = make_probes(key, (N, n_probes), dtype, device)
    alphas, betas = lanczos_tridiag(matvec, probes, n_lanczos)
    T = (torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, 1)
         + torch.diag_embed(betas.T, -1))
    finite = torch.isfinite(T).all(dim=-1).all(dim=-1)
    T = torch.where(finite[:, None, None], T, torch.zeros_like(T))
    theta, V = torch.linalg.eigh(T)
    tau2 = V[:, 0, :] ** 2
    theta = torch.clamp(theta, min=torch.finfo(dtype).tiny)
    quads = torch.sum(tau2 * torch.log(theta), dim=-1)
    quads = torch.where(finite, quads, torch.full_like(quads, math.nan))
    return (N / n_probes) * torch.sum(quads)


def _as_data(X, y, s2):
    X = torch.as_tensor(X)
    kw = {"dtype": X.dtype, "device": X.device}
    y = torch.as_tensor(y, **kw)
    s2 = None if s2 is None else torch.as_tensor(s2, **kw)
    return X, y, s2


def cg_nlml(
    spec: ModelSpec,
    hyp,
    X,
    y,
    s2=None,
    key=None,
    compute_grad: bool = False,
    tol: float = 1e-5,
    row_chunk: int = 1024,
    max_iter: int = 500,
    n_probes: int = 8,
    n_lanczos: int = 32,
    sol0=None,
    return_sol: bool = False,
):
    """Estimated negative log marginal likelihood, and with
    ``compute_grad`` its gradient, with a never-materialized kernel
    matrix (the BBMM training objective):

    - the quadratic term 0.5 r^T alpha, alpha from matrix-free CG;
    - 0.5 logdet by stochastic Lanczos quadrature (:func:`slq_logdet`);
    - the gradient from dnlZ = 0.5 tr((A^{-1} - aa^T) dA) - dm^T a, with
      tr(A^{-1} dA) replaced by the Hutchinson estimator (1/P) sum_i
      u_i^T dA z_i, u_i = A^{-1} z_i from the same CG batch; the
      directional derivatives come from autograd of a surrogate whose
      gradient equals the estimator, never from a materialized dK.

    ``X`` is a tensor (its device and dtype are the computation's);
    ``y`` (N, 1) and ``s2`` follow it.  ``key`` is the probes' integer
    seed (None: 0); a fixed seed makes the objective deterministic
    (common random numbers).  Returns a float (and a float64 numpy
    gradient); with ``return_sol`` also the padded CG solution block (N',
    1 + P), kept on the device, and the iteration count: pass the block
    back as ``sol0`` to warm-start the next call."""
    X, y, s2 = _as_data(X, y, s2)
    N = X.shape[0]
    row_chunk = int(min(row_chunk, N))
    Xp, yp, s2p, n_real = _pad_panel_batch(X, y, s2, row_chunk)
    out = _cg_nlml_impl(
        spec, bool(compute_grad), row_chunk, int(max_iter), int(n_probes),
        int(n_lanczos), hyp, Xp, yp, 0 if key is None else int(key), tol,
        s2=s2p, n_real=n_real, sol0=sol0,
    )
    nlml, grad, sol, iters = out
    nlml = float(nlml)
    if return_sol:
        if compute_grad:
            return nlml, grad, sol, iters
        return nlml, sol, iters
    if compute_grad:
        return nlml, grad
    return nlml


def _cg_nlml_impl(spec, compute_grad, row_chunk, max_iter, n_probes,
                  n_lanczos, hyp, X, y, key, tol, s2=None, n_real=None,
                  sol0=None):
    """Returns (nlml tensor, gradient numpy or None, solution block,
    CG iterations) on padded data."""
    N = X.shape[0]
    dtype, device = X.dtype, X.device
    hyp = torch.as_tensor(hyp).to(dtype=dtype, device=device)
    if n_real is not None:
        mask = (torch.arange(N, device=device) < n_real).to(dtype)
        n_eff = n_real
    else:
        mask = None
        n_eff = N

    def parts(h):
        hyp_cov, hyp_noise, hyp_mean = spec.split_hyp(h)
        sn2 = noise_variance(spec, hyp_noise, y, s2, dtype)
        sn2_vec = torch.broadcast_to(torch.reshape(sn2, (-1,)), (N,))
        m = mean_value(spec, hyp_mean, X)[:, None]
        if mask is not None:
            sn2_vec = torch.where(mask > 0, sn2_vec, torch.ones_like(sn2_vec))
            m = m * mask[:, None] + y * (1.0 - mask[:, None])
        return hyp_cov, sn2_vec, m

    with torch.no_grad():
        hyp_cov, sn2_vec, m = parts(hyp)
        r = y - m
        mv = _operator(spec, hyp_cov, X, sn2_vec, row_chunk, mask)
        # One probe block for the Hutchinson solves and the quadrature.
        Z = make_probes(key, (N, n_probes), dtype, device)
        sol, _, cg_iters = _cg(mv, torch.cat([r, Z], dim=1), tol, max_iter,
                               x0=sol0)
        alpha, U = sol[:, :1], sol[:, 1:]
        logdet = slq_logdet(mv, N, key, dtype, n_probes, n_lanczos, probes=Z)
        nlml = (0.5 * torch.sum(r * alpha) + 0.5 * logdet
                + 0.5 * n_eff * math.log(2.0 * math.pi))
    if not compute_grad:
        return nlml, None, sol, cg_iters
    grad = _surrogate_grad(spec, hyp, X, y, mask, parts, row_chunk, alpha,
                           U, Z, n_probes)
    return nlml, grad, sol, cg_iters


def _surrogate_grad(spec, hyp, X, y, mask, parts, row_chunk, alpha, U, Z,
                    n_probes):
    """The gradient of JAX's surrogate (:491-508) with the solves held
    constant,

        psi(h) = r(h)^T alpha - 0.5 alpha^T A(h) alpha,
        phi(h) = 0.5/P sum_i u_i^T A(h) z_i,

    split into its noise and mean part (one autograd pass) and its kernel
    part, sum_ij K_ij(h) W_i . V_j with V = [alpha, Z] and W = [-alpha/2,
    U/(2P)] (masked), built and differentiated one (row_chunk, N) panel at
    a time with the plain composition.  Returns float64 numpy."""
    cov_N = spec.cov_N
    with torch.enable_grad():
        h = hyp.detach().clone().requires_grad_(True)
        _, sn2_h, m_h = parts(h)
        s = sn2_h[:, None]
        val = (torch.sum((y - m_h) * alpha) - 0.5 * torch.sum(alpha * s * alpha)
               + 0.5 / n_probes * torch.sum(U * s * Z))
        if val.requires_grad:
            (grad,) = torch.autograd.grad(val, h)
        else:
            grad = torch.zeros_like(h)
    V = torch.cat([alpha, Z], dim=1)
    W = torch.cat([-0.5 * alpha, (0.5 / n_probes) * U], dim=1)
    if mask is not None:
        V = V * mask[:, None]
        W = W * mask[:, None]
    g_cov = torch.zeros((cov_N,), dtype=hyp.dtype, device=hyp.device)
    for start in range(0, X.shape[0], row_chunk):
        stop = start + row_chunk
        with torch.enable_grad():
            hc = hyp[:cov_N].detach().clone().requires_grad_(True)
            Kp = kernel_matrix_plain(spec.cov, hc, X[start:stop], X)
            val = torch.sum(W[start:stop] * (Kp @ V))
            (g,) = torch.autograd.grad(val, hc)
        del Kp, val
        g_cov = g_cov + g
    grad = grad.clone()
    grad[:cov_N] += g_cov
    return grad.detach().cpu().numpy().astype(np.float64)


def cg_log_post_raw(
    spec: ModelSpec,
    tol: float,
    row_chunk: int,
    max_iter: int,
    n_probes: int,
    n_lanczos: int,
    has_s2: bool,
    has_prior: bool,
):
    """``(log_post, log_prior)`` for MCMC on the matrix-free NLML, each
    taking ``(hyp, X, y[, s2][, prior_pack], probe_seed)``.

    The caller passes ONE probe seed for the whole chain (common random
    numbers), so the chain targets a deterministic fixed-probe surrogate
    of the hyperposterior whose log-density error is the SLQ/Hutchinson
    estimator's (cf. arXiv:2412.20884).  ``hyp`` is a float64 tensor or
    array; both return 0-d float64 tensors."""
    from ..core.priors import log_prior as _log_prior

    def _split(args):
        X, y = args[0], args[1]
        i = 2
        s2 = pack = None
        if has_s2:
            s2 = args[i]
            i += 1
        if has_prior:
            pack = args[i]
            i += 1
        return X, y, s2, pack, args[i]

    def _hyp64(hyp, X):
        return torch.as_tensor(hyp, dtype=torch.float64).to(X.device)

    def log_post(hyp, *args):
        X, y, s2, pack, key = _split(args)
        X, y, s2 = _as_data(X, y, s2)
        rc = int(min(row_chunk, X.shape[0]))
        Xp, yp, s2p, n_real = _pad_panel_batch(X, y, s2, rc)
        with torch.no_grad():
            nl = _cg_nlml_impl(spec, False, rc, max_iter, n_probes, n_lanczos,
                               hyp, Xp, yp, int(key), tol, s2=s2p,
                               n_real=n_real)[0]
            v = -nl.to(torch.float64)
            if pack is not None:
                v = v + _log_prior(pack, _hyp64(hyp, X))
        return v

    def prior_only(hyp, *args):
        X, _, _, pack, _ = _split(args)
        if pack is None:
            return torch.zeros((), dtype=torch.float64)
        with torch.no_grad():
            return _log_prior(pack, _hyp64(hyp, torch.as_tensor(X)))

    return log_post, prior_only


def fit_cg(
    spec: ModelSpec,
    X,
    y,
    s2=None,
    hyp0=None,
    LB=None,
    UB=None,
    key=None,
    tol: float = 1e-4,
    cg_tol: float = 1e-5,
    row_chunk: int = 1024,
    max_iter: int = 500,
    n_probes: int = 8,
    n_lanczos: int = 32,
    max_opt_iter: int = 100,
    ftol: float = 1e-9,
    warm_start: bool = True,
):
    """MAP hyperparameter fit past the Cholesky N limit: scipy's bounded
    L-BFGS-B over :func:`cg_nlml` with one fixed probe seed ``key``
    (common random numbers), so the optimizer sees a deterministic
    surface.  ``warm_start`` carries each evaluation's CG solution block,
    on the device, into the next evaluation's initial guess (Lin et al.
    2024); the solves run to the same relative tolerance, only the
    iteration count drops.  ``tol`` is L-BFGS-B's gradient tolerance,
    ``ftol`` its relative-decrease stop.

    Returns (hyp (h,), scipy OptimizeResult) with the CG iterations of
    every evaluation in ``res.cg_iters``."""
    import scipy.optimize as spo

    if hyp0 is None:
        raise ValueError("fit_cg requires an initial hyperparameter vector")
    hyp0 = np.asarray(hyp0, dtype=np.float64).ravel()
    state = {"sol": None}
    iter_counts = []

    def fg(h):
        v, g, sol, iters = cg_nlml(
            spec, h, X, y, s2, key=key, compute_grad=True, tol=cg_tol,
            row_chunk=row_chunk, max_iter=max_iter, n_probes=n_probes,
            n_lanczos=n_lanczos, sol0=state["sol"], return_sol=True,
        )
        if warm_start:
            state["sol"] = sol
            iter_counts.append(iters)
        return v, g

    bounds = None
    if LB is not None or UB is not None:
        LB = np.full_like(hyp0, -np.inf) if LB is None else np.asarray(LB)
        UB = np.full_like(hyp0, np.inf) if UB is None else np.asarray(UB)
        bounds = list(zip(LB, UB))
    res = spo.minimize(
        fg,
        hyp0,
        jac=True,
        bounds=bounds,
        method="L-BFGS-B",
        options={"maxiter": max_opt_iter, "ftol": ftol, "gtol": tol},
    )
    if iter_counts:
        res.cg_iters = np.asarray(iter_counts)
    return res.x, res


def cg_posterior_weights(
    spec: ModelSpec,
    hyp,
    X,
    y,
    s2,
    tol=1e-6,
    row_chunk: int = 1024,
    max_iter: int = 1000,
):
    """alpha = (K + sn2 I)^{-1} (y - m) by matrix-free CG.  N must be a
    multiple of ``row_chunk`` (:func:`cg_predict` pads).  Returns (alpha
    (N, 1), relative residual (1,), iterations)."""
    X, y, s2 = _as_data(X, y, s2)
    N = X.shape[0]
    hyp = torch.as_tensor(hyp).to(dtype=X.dtype, device=X.device)
    hyp_cov, hyp_noise, hyp_mean = spec.split_hyp(hyp)
    with torch.no_grad():
        sn2 = noise_variance(spec, hyp_noise, y, s2, X.dtype)
        sn2_vec = torch.broadcast_to(torch.reshape(sn2, (-1,)), (N,))
        r = y - mean_value(spec, hyp_mean, X)[:, None]
        mv = _operator(spec, hyp_cov, X, sn2_vec, row_chunk, None)
        return _cg(mv, r, tol, max_iter)


def _cg_solve(spec, row_chunk, max_iter, hyp_cov, Xp, b, sn2_vec, mask, tol,
              Lk):
    """Masked CG solve against (K + sn2 I), preconditioned by Woodbury
    when ``Lk`` is given: the serving path's solve."""
    mv = _operator(spec, hyp_cov, Xp, sn2_vec, row_chunk, mask)
    precond = None if Lk is None else woodbury_preconditioner(Lk, sn2_vec)
    return _cg(mv, b, tol, max_iter, precond)


def cg_predict(
    spec: ModelSpec,
    hyp,
    X,
    y,
    s2,
    xs,
    compute_var: bool = False,
    tol: float = 1e-6,
    row_chunk: int = 1024,
    test_chunk: int = 1024,
    max_iter: int = 1000,
    precond_rank: int = 0,
    alpha0=None,
):
    """Exact-GP prediction with a never-materialized kernel matrix.

    Mean m(xs) + K(X, xs)^T alpha with alpha from CG; variance kss -
    K(X, xs)^T (K + sn2 I)^{-1} K(X, xs), the columns' solves batched
    through the same CG a test chunk at a time.  ``precond_rank`` > 0
    adds the pivoted-Cholesky / Woodbury preconditioner.  ``alpha0``: an
    earlier call's ``info["alpha"]`` (padded, at the same hyperparameters
    and data) skips the weight solve.

    ``X``, ``xs`` tensors on one device, ``y`` and ``s2`` following ``X``.
    Returns numpy (mu (M, 1), var (M, 1) or None, info): ``info`` holds
    the padded ``alpha`` (on the device), and the relative residuals and
    iterations of the solves (``alpha_rel_residual``, ``alpha_iters``;
    ``var_rel_residual``, ``var_iters``, the largest over the chunks); a
    solve that stopped at ``max_iter`` shows it there."""
    X, y, s2 = _as_data(X, y, s2)
    dtype, device = X.dtype, X.device
    hyp = torch.as_tensor(hyp).to(dtype=dtype, device=device)
    xs = torch.as_tensor(xs).to(dtype=dtype, device=device)
    M = xs.shape[0]
    N_true = X.shape[0]
    Xp, yp, s2p, _ = _pad_panel_batch(X, y, s2, row_chunk)
    # Padding repeats a row, which makes K singular without noise: the
    # mask cuts the padded rows out of the operator, the residual and the
    # cross-covariances.
    mask = (torch.arange(Xp.shape[0], device=device) < N_true).to(dtype)
    hyp_cov, hyp_noise, hyp_mean = spec.split_hyp(hyp)
    with torch.no_grad():
        sn2 = noise_variance(spec, hyp_noise, yp, s2p, dtype)
        sn2_vec = torch.broadcast_to(torch.reshape(sn2, (-1,)), (Xp.shape[0],))
        sn2_vec = torch.where(mask > 0, sn2_vec, torch.ones_like(sn2_vec))
        r = (yp - mean_value(spec, hyp_mean, Xp)[:, None]) * mask[:, None]
        Lk = (pivoted_cholesky(spec, hyp_cov, Xp, precond_rank, mask)
              if precond_rank > 0 else None)

        def solve(b):
            return _cg_solve(spec, int(row_chunk), int(max_iter), hyp_cov, Xp,
                             b, sn2_vec, mask, tol, Lk)

        if alpha0 is not None:
            alpha = torch.as_tensor(alpha0).to(dtype=dtype, device=device)
            info = {"alpha_reused": True}
        else:
            alpha, res_a, it_a = solve(r)
            info = {"alpha_rel_residual": float(torch.max(res_a)),
                    "alpha_iters": int(it_a)}
        info["alpha"] = alpha

        mu_parts, var_parts = [], []
        for start in range(0, M, test_chunk):
            xs_c = xs[start : start + test_chunk]
            Ks = cov_matrix(spec, hyp_cov, Xp, Z=xs_c) * mask[:, None]
            m_star = mean_value(spec, hyp_mean, xs_c)[:, None]
            mu_parts.append(m_star + Ks.T @ alpha)
            if compute_var:
                V, res_v, it_v = solve(Ks)
                info["var_rel_residual"] = max(
                    info.get("var_rel_residual", 0.0), float(torch.max(res_v)))
                info["var_iters"] = max(info.get("var_iters", 0), int(it_v))
                kss = cov_matrix(spec, hyp_cov, xs_c, diag=True)[:, None]
                var_parts.append(kss - torch.sum(Ks * V, dim=0)[:, None])
                del V
            del Ks
        mu = torch.cat(mu_parts).cpu().numpy()
        var = None
        if compute_var:
            var = np.maximum(torch.cat(var_parts).cpu().numpy(), 0.0)
    return mu, var, info
