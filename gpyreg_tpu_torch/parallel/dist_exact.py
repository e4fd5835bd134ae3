"""The distributed exact GP: the kernel matrix built, factored and served
row-sharded over a mesh.

Port of ``gpyreg_tpu/parallel/dist_exact.py`` (:76-612): ``plan``,
``_scaled_model``, the slab build of ``_fit_fn`` (:347-386), the blocked
Cholesky, the distributed forward and backward substitutions, the NLML
sum, ``DistExactPosterior``, ``dist_exact_fit``, ``dist_exact_nlml`` and
``dist_exact_predict``.  The scaled matrix B = I + sW K sW
(reference gaussian_process.py:2394-2399) is sharded by block rows: shard
i holds rows [i * rows, (i + 1) * rows) of B, a (rows, Np) slab on its
device, so a device holds N^2 / P of it, the only exact path whose
per-device memory falls with the shard count.  Each shard builds its
slab as the cross-covariance K(X_rows, X) (``core.model.cov_matrix``: the
kernel tile on a float32 card), scaled and masked in place.

The Cholesky is right-looking over panels of width ``b``.  For panel j
the owner of rows [j b, (j + 1) b), shard j b // rows (``plan`` keeps a
block on one shard), factors the (b, b) diagonal block, a copy of that
factor goes to every shard with rows below it, each of those solves its
part of the panel in place and subtracts its product with the panel rows
it needs, gathered on its device: shard s updates its rows below the
panel in the columns from the panel's end to its own last row, the
trailing columns it still needs, and nothing else.  The JAX package
updates the full width under a mask (:100-138, about 3x the ideal
flops) so that its loop body keeps one compiled shape, and
``_dist_cholesky_two_level`` (:141-231) trades that waste against the
number of compiled bodies.  Eager PyTorch compiles nothing, so the two
loops collapse into this one: ``algorithm`` accepts both names, both
give this factor, and an unknown name is refused.  The trailing update
is a plain product (``addmm_``, TF32 off as PyTorch's default), as the
JAX package computes it outside any Pallas kernel.  The strict upper
triangle of each slab, stale partial updates and untouched entries of B,
is zeroed at the end, as JAX's final ``where`` makes it (:137).

A diagonal block that does not factor gives NaN, not an exception and
not a partial factor: ``cholesky_ex``'s factor is replaced by NaN where
its ``info`` is not 0, on the device with no sync, and the NaN reaches
``nlml``, as ``lax.linalg.cholesky``'s does in JAX (:336-340, the
single-attempt contract of ``core.nlml.nlz_design``).

The substitutions run the same panel loop: forward, the owner solves its
block and every shard below subtracts its panel times the block's
solution; backward, each shard's contribution to a block is summed on
the owner (``mesh.psum``).  A block that only one shard owns
(``_block_owner_slice`` / ``_diag_block`` with their ``psum``, :88-97,
:297-303) is read from the owner directly.  No work waits on the host:
every shard's operations are issued before anything is pulled.

Left out, being TPU-only: the ``lru_cache``\\ d programs ``_fit_fn`` and
``_predict_fn`` with their ``shard_map`` and ``NamedSharding`` layouts,
and ``_idx`` (:69-73), the int32 start indices of ``dynamic_slice``.
"""

import math

import numpy as np
import torch

from ..core.model import ModelSpec, cov_matrix, mean_value, noise_variance
from ..tracing import phase
from .mesh import Mesh, _pad_rows, _tensor, all_gather, psum

_LOG_2PI = math.log(2.0 * math.pi)
ALGORITHMS = ("masked_full", "two_level")


def plan(N: int, n_devices: int, b: int):
    """(Np, rows a shard, panels): Np is the smallest multiple of
    ``n_devices * b`` >= N, so ``b`` divides each shard's rows and no
    (b, b) diagonal block straddles two shards."""
    chunk = n_devices * b
    Np = -(-N // chunk) * chunk
    return Np, Np // n_devices, Np // b


def _scaled_model(spec, hyp, X, y, s2, n_real):
    """The replicated O(N) pieces: (hyp_cov, mask, sW, r, the sum of the
    real rows' log noise).  Padded rows take sW = 1 and a zero residual,
    so that their block of B is exactly I (no share of the log-determinant
    or the quadratic form)."""
    Np, dtype = X.shape[0], X.dtype
    hyp_cov, hyp_noise, hyp_mean = spec.split_hyp(hyp)
    real = torch.arange(Np, device=X.device) < n_real
    sn2 = torch.broadcast_to(
        torch.reshape(noise_variance(spec, hyp_noise, y, s2, dtype), (-1,)),
        (Np,))
    sn2 = torch.where(real, sn2, torch.ones_like(sn2))
    sW = 1.0 / torch.sqrt(sn2)
    r = y - mean_value(spec, hyp_mean, X)[:, None]
    r = torch.where(real[:, None], r, torch.zeros_like(r))
    log_sn2_sum = torch.sum(torch.where(real, torch.log(sn2),
                                        torch.zeros_like(sn2)))
    return hyp_cov, real.to(dtype), sW, r, log_sn2_sum


def _build_slabs(spec, mesh, hyp_cov, X, mask, sW, jitter):
    """Shard i's rows of B + jitter I (jitter on real rows only, the
    padded blocks stay exactly I): K(X_rows, X) scaled and masked in
    place."""
    rows = X.shape[0] // mesh.size
    slabs = []
    for i, (h, Xd, md, sWd) in enumerate(mesh.replicate((hyp_cov, X, mask,
                                                         sW))):
        a = i * rows
        slab = cov_matrix(spec, h, Xd[a : a + rows], Z=Xd)
        w = sWd * md
        slab.mul_(w[a : a + rows, None]).mul_(w[None, :])
        slab.diagonal(offset=a).add_(1.0 + jitter * md[a : a + rows])
        slabs.append(slab)
    return slabs


def _below(s, rows, c1):
    """First local row of shard s at or after global row c1."""
    return max(0, c1 - s * rows)


def _cholesky(slabs, devices, b):
    """The blocked right-looking Cholesky of the row-sharded B, in place
    (module docstring).  Each slab ends holding its rows of the lower
    factor, zero above the diagonal.  Each step issues its copies between
    devices before the work that follows them: a copy runs on its
    source's stream, behind whatever that shard was given before."""
    P, rows = len(slabs), slabs[0].shape[0]
    for c0 in range(0, P * rows, b):
        c1 = c0 + b
        o, lo = divmod(c0, rows)
        blk = slabs[o][lo : lo + b, c0:c1]
        Ljj, info = torch.linalg.cholesky_ex(blk)
        blk.copy_(torch.where(info == 0, Ljj, torch.full_like(Ljj, math.nan)))
        # The shards with rows below the block, each with a copy of it.
        below = [(s, r0, blk.to(devices[s])) for s in range(o, P)
                 for r0 in (_below(s, rows, c1),) if r0 < rows]
        panel = []
        for s, r0, Ljj_s in below:
            col = slabs[s][r0:, c0:c1]
            # L_ij = A_ij L_jj^-T: the panel solve, in place.
            col.copy_(torch.linalg.solve_triangular(
                Ljj_s.mT, col, upper=True, left=False))
            panel.append((s, r0, col))
        W = [all_gather([c for t, _, c in panel if t <= s], devices[s])
             for s, _, _ in panel]
        for (s, r0, col), W_s in zip(panel, W):
            slabs[s][r0:, c1 : (s + 1) * rows].addmm_(col, W_s.mT, alpha=-1.0)
    for s, slab in enumerate(slabs):
        slab.tril_(s * rows)
    return slabs


def _solve_lower(slabs, devices, b, rhs):
    """Forward substitution L z = rhs over row-sharded L and rhs (lists
    of the shards' blocks); returns z's blocks."""
    P, rows = len(slabs), slabs[0].shape[0]
    z = [r.clone() for r in rhs]
    for c0 in range(0, P * rows, b):
        c1 = c0 + b
        o, lo = divmod(c0, rows)
        zj = torch.linalg.solve_triangular(
            slabs[o][lo : lo + b, c0:c1], z[o][lo : lo + b], upper=False)
        z[o][lo : lo + b] = zj
        below = [(s, r0, zj.to(devices[s])) for s in range(o, P)
                 for r0 in (_below(s, rows, c1),) if r0 < rows]
        for s, r0, zj_s in below:
            z[s][r0:].addmm_(slabs[s][r0:, c0:c1], zj_s, alpha=-1.0)
    return z


def _solve_upper(slabs, devices, b, rhs):
    """Backward substitution L^T x = rhs over row-sharded L and rhs;
    each shard's share of a block, L_sj^T x_s, is summed on the block's
    owner.  Returns x's blocks."""
    P, rows = len(slabs), slabs[0].shape[0]
    x = [torch.zeros_like(r) for r in rhs]
    for c0 in reversed(range(0, P * rows, b)):
        c1 = c0 + b
        o, lo = divmod(c0, rows)
        blk = rhs[o][lo : lo + b]
        parts = [slabs[s][r0:, c0:c1].mT @ x[s][r0:]
                 for s in range(o, P)
                 for r0 in (_below(s, rows, c1),) if r0 < rows]
        if parts:
            blk = blk - psum(parts, devices[o])
        x[o][lo : lo + b] = torch.linalg.solve_triangular(
            slabs[o][lo : lo + b, c0:c1].mT, blk, upper=True)
    return x


class DistExactPosterior:
    """A row-sharded exact posterior, made by :func:`dist_exact_fit` and
    served by :func:`dist_exact_predict`: ``slabs[i]`` (rows, Np), shard
    i's rows of the lower Cholesky factor of B, and ``alphas[i]`` (rows,
    1), its rows of alpha, on ``mesh.devices[i]``; ``X`` (Np, D) the
    padded inputs and ``sW`` (Np,) on the first shard's device; ``nlml``
    the exact negative log marginal likelihood, a 0-d tensor there."""

    def __init__(self, spec, mesh, b, Np, n_real, hyp, X, slabs, alphas, sW,
                 nlml):
        self.spec = spec
        self.mesh = mesh
        self.b = b
        self.Np = Np
        self.n_real = n_real
        self.hyp = hyp
        self.X = X
        self.slabs = slabs
        self.alphas = alphas
        self.sW = sW
        self.nlml = nlml

    @property
    def alpha(self):
        """alpha (Np, 1), gathered on the first shard's device (the
        padded rows are exactly 0)."""
        return all_gather(self.alphas, self.mesh.devices[0])


def _hyp_tensor(hyp, X):
    return torch.as_tensor(np.asarray(hyp, dtype=np.float64)).to(X.device,
                                                                 X.dtype)


def _synchronize(mesh):
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def dist_exact_fit(spec: ModelSpec, mesh: Mesh, hyp, X, y, s2=None,
                   b: int = 512, jitter: float = 0.0,
                   algorithm: str = "masked_full", timings=None):
    """Build and factor B row-sharded over ``mesh`` and solve for alpha;
    returns a :class:`DistExactPosterior` with the exact ``nlml``.

    N is padded to a multiple of ``mesh.size * b`` with inert identity
    rows (``_scaled_model``); ``b`` is first cut to max(32, N // shards).
    A shard holds one (N / P, N) slab.  ``jitter`` is added to the unit
    diagonal of the real rows (B's eigenvalues are >= 1, so 0 is the
    default).  ``algorithm`` is "masked_full" or "two_level", the JAX
    package's two loops, which compute the same factor here (module
    docstring).  ``X`` (numpy or a tensor) sets the dtype.  Output warping
    is refused.  ``timings``, when a dict, adds the seconds of the build
    and factorization (``"factor_s"``) and of the solves and the NLML
    (``"solve_s"``), each ended by synchronizing the mesh's devices
    (``tracing.phase``: the spans ``gpyreg.fit.factor`` and
    ``gpyreg.fit.solve``).
    """
    if spec.outwarp is not None:
        raise ValueError(
            "The distributed exact tier does not support output warping; "
            "use the replicated path (core.nlml) for warped models."
        )
    if algorithm not in ALGORITHMS:
        raise ValueError(f"Unknown algorithm {algorithm!r}")
    home = mesh.devices[0]
    X = _tensor(X).to(home)
    y = _tensor(y).to(home, X.dtype)
    N, P = X.shape[0], mesh.size
    b = min(int(b), max(32, N // P))
    Np, rows, _ = plan(N, P, b)
    X = _pad_rows(X, Np)
    y = _pad_rows(y, Np, 0.0)
    if s2 is not None:
        s2 = _pad_rows(_tensor(s2).to(home, X.dtype), Np, 1.0)
    with torch.no_grad():
        with phase(timings, "factor_s"):
            hyp_cov, mask, sW, r, log_sn2_sum = _scaled_model(
                spec, _hyp_tensor(hyp, X), X, y, s2, N)
            slabs = _cholesky(
                _build_slabs(spec, mesh, hyp_cov, X, mask, sW,
                             float(jitter)),
                mesh.devices, b)
            if timings is not None:
                _synchronize(mesh)
        with phase(timings, "solve_s"):
            sW_r = [(sW * r[:, 0])[i * rows : (i + 1) * rows, None].to(d)
                    for i, d in enumerate(mesh.devices)]
            z = _solve_lower(slabs, mesh.devices, b, sW_r)
            x = _solve_upper(slabs, mesh.devices, b, z)
            alphas = [sW[i * rows : (i + 1) * rows, None].to(d) * xi
                      for i, (d, xi) in enumerate(zip(mesh.devices, x))]
            quad = psum([torch.sum(zi * zi) for zi in z], home)
            logdet_half = psum(
                [torch.sum(torch.log(slab.diagonal(offset=i * rows)))
                 for i, slab in enumerate(slabs)], home)
            nlml = (0.5 * quad + logdet_half + 0.5 * log_sn2_sum
                    + 0.5 * N * _LOG_2PI)
            if timings is not None:
                _synchronize(mesh)
    return DistExactPosterior(spec, mesh, b, Np, N,
                              np.asarray(hyp, dtype=np.float64), X, slabs,
                              alphas, sW, nlml)


def dist_exact_nlml(spec: ModelSpec, mesh: Mesh, hyp, X, y, s2=None,
                    b: int = 512, jitter: float = 0.0):
    """The exact NLML with the kernel matrix sharded over the mesh."""
    return float(dist_exact_fit(spec, mesh, hyp, X, y, s2, b, jitter).nlml)


def dist_exact_predict(post: DistExactPosterior, xs, chunk: int = 1024):
    """Latent predictive mean and variance at ``xs`` against the
    row-sharded factor (``gp._compute_mu_s2`` with the L_chol
    parametrization, reference gaussian_process.py:971-1011): mu = m* +
    Ks^T alpha, a sum over shards, and s2 = k** - |L^-1 sW Ks|^2 by the
    distributed forward substitution with the chunk's points as columns;
    nothing N-sized is gathered.  The points go ``chunk`` at a time (cut
    to M rounded up to 64), the last chunk padded with repeats of its last
    point, as JAX pads them for one compiled program.  s2 is clamped at 0
    (float32 rounds it to tiny negatives near the data).  Returns numpy
    (mu, s2), (M,) each, in the posterior's dtype."""
    mesh, rows = post.mesh, post.Np // post.mesh.size
    home, dtype = mesh.devices[0], post.X.dtype
    xs = _tensor(xs).to(home, dtype)
    xs = xs.reshape(-1, post.X.shape[1]) if xs.ndim < 2 else xs
    M = xs.shape[0]
    chunk = min(int(chunk), -(-M // 64) * 64)
    with torch.no_grad():
        hyp = _hyp_tensor(post.hyp, post.X)
        hyp_cov, _, hyp_mean = post.spec.split_hyp(hyp)
        real = (torch.arange(post.Np, device=home) < post.n_real).to(dtype)
        shards = [
            (d, h, post.X[i * rows : (i + 1) * rows].to(d),
             real[i * rows : (i + 1) * rows, None].to(d),
             post.sW[i * rows : (i + 1) * rows, None].to(d))
            for i, (d, h) in enumerate(zip(mesh.devices,
                                           mesh.replicate(hyp_cov)))
        ]
        mus, s2s = [], []
        for c in range(0, M, chunk):
            xc = _pad_rows(xs[c : c + chunk], chunk)
            xcs = [xc.to(d) for d, *_ in shards]
            Ks = [cov_matrix(post.spec, h, Xr, Z=xd).mul_(mr)
                  for (_, h, Xr, mr, _), xd in zip(shards, xcs)]
            mu = mean_value(post.spec, hyp_mean, xc) + psum(
                [(K.T @ a)[:, 0] for K, a in zip(Ks, post.alphas)], home)
            V = _solve_lower(post.slabs, mesh.devices, post.b,
                             [sw * K for (*_, sw), K in zip(shards, Ks)])
            kss = cov_matrix(post.spec, hyp_cov, xc, diag=True)
            s2 = kss - psum([torch.sum(v * v, dim=0) for v in V], home)
            mus.append(mu)
            s2s.append(s2)
        mu = torch.cat(mus)[:M]
        s2 = torch.clamp(torch.cat(s2s)[:M], min=0.0)
    return mu.cpu().numpy(), s2.cpu().numpy()
