"""The distributed exact GP: the kernel matrix built, factored and served
row-sharded over a mesh.

Port of ``gpyreg_tpu/parallel/dist_exact.py`` (:76-612): ``plan``,
``_scaled_model``, the slab build of ``_fit_fn`` (:347-386), the blocked
Cholesky, the distributed forward and backward substitutions, the NLML
sum, ``DistExactPosterior``, ``dist_exact_fit``, ``dist_exact_nlml`` and
``dist_exact_predict``.  The scaled matrix B = I + sW K sW
(reference gaussian_process.py:2394-2399) is sharded by block rows dealt
round-robin over the P shards: panel p, the b rows [p b, (p + 1) b), lies
on shard p mod P as its local block p // P, so local block l of shard i
is panel l P + i, and each shard keeps its blocks in global order.
:func:`dealt_rows` gives the global rows a shard holds in the order of
its slab's rows (``DistExactPosterior.shard_rows`` a posterior's); every
reader of the layout goes through it.  A shard holds its Np / P rows as
one (Np / P, Np) slab on its device, so a device holds N^2 / P of B, the
only exact path whose per-device memory falls with the shard count.
Each shard gathers its rows of X on its own device and builds its slab
as one cross-covariance K(X_rows, X) (``core.model.cov_matrix``: the
kernel tile on a float32 card), scaled and masked in place.

The Cholesky is right-looking over panels of width ``b``.  For panel p
the owner, shard p mod P, factors the (b, b) diagonal block, a copy of
that factor goes to every other shard with rows below the panel, and
each of those solves its part of the panel in place.  Every shard holds
rows down to Np, so each gathers every other shard's solved panel rows,
the solve's own contiguous output, into global order on its device.
Shard s then updates each of its row blocks below the panel, global
block g, in the columns from the panel's end to the end of block g: the
lower triangle of B and its diagonal blocks, one ``addmm_`` a block.
Dealt round-robin, each shard does about Np^3 / (6 P) of the trailing
multiply-adds (``UPDATE_MACS`` counts them on the host).  The JAX
package updates the full width under a mask (:100-138, about 3x the
ideal flops) so that its loop body keeps one compiled shape, and
``_dist_cholesky_two_level`` (:141-231) trades that waste against the
number of compiled bodies.
Eager PyTorch compiles nothing, so the two loops collapse into this one:
``algorithm`` accepts both names, both give this factor, and an unknown
name is refused.  The trailing update is a plain product (TF32 off as
PyTorch's default), as the JAX package computes it outside any Pallas
kernel.  The strict upper triangle of each row, stale partial updates
and untouched entries of B, is zeroed at the end, block by block along
each local block's own global columns, as JAX's final ``where`` makes it
(:137).

A diagonal block that does not factor gives NaN, not an exception and
not a partial factor: ``cholesky_ex``'s factor is replaced by NaN where
its ``info`` is not 0, on the device with no sync, and the NaN reaches
``nlml``, as ``lax.linalg.cholesky``'s does in JAX (:336-340, the
single-attempt contract of ``core.nlml.nlz_design``).

The substitutions run the same panel loop over the same layout: forward,
the owner solves its block and every shard with rows below subtracts its
panel times the block's solution; backward, each shard's contribution to
a block is summed on the owner (``mesh.psum``).  A block that only one
shard owns (``_block_owner_slice`` / ``_diag_block`` with their
``psum``, :88-97, :297-303) is read from the owner directly.  alpha is
gathered on the first shard's device inside the fit, so reading it
copies nothing between devices.  No work waits on the host: every
shard's operations are issued before anything is pulled.

Every block that crosses shards goes through ``mesh.move`` with its
shard's device, so ``mesh.PEER_COPIES`` counts each copy between two
cards.  Spans (``tracing.span``): ``gpyreg.dist.build`` (the slabs),
``gpyreg.dist.cholesky`` (the panel loop), ``gpyreg.dist.solve_lower``,
``gpyreg.dist.solve_upper`` and ``gpyreg.dist.nlml``; the copies of the
hyperparameters and of host data to the card are the syncs
``gpyreg.sync.dist_hyp`` and ``gpyreg.sync.dist_data``.

Left out, being TPU-only: the ``lru_cache``\\ d programs ``_fit_fn`` and
``_predict_fn`` with their ``shard_map`` and ``NamedSharding`` layouts,
and ``_idx`` (:69-73), the int32 start indices of ``dynamic_slice``.
"""

import math

import numpy as np
import torch

from ..core.model import ModelSpec, cov_matrix, mean_value, noise_variance
from ..tracing import phase, span, to_device
from .mesh import Mesh, _pad_rows, move, psum

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


def dealt_rows(i, n_shards, rows, b, device=None):
    """The global rows of B that shard ``i`` of ``n_shards`` holds (``rows``
    a shard, panels of ``b``), in the order of its slab's rows: local
    block l is panel l * n_shards + i."""
    j = torch.arange(rows, device=device)
    return (j // b * n_shards + i) * b + j % b


def _diagonal(slab, i, n_shards, b):
    """The entries of shard ``i``'s slab on B's diagonal as a (rows / b, b)
    view: local block l's lie in the columns of its own panel."""
    nr = slab.shape[0] // b
    blocks = slab.view(nr, b, nr, n_shards, b)[:, :, :, i, :]
    return blocks.diagonal(dim1=0, dim2=2).diagonal(dim1=0, dim2=1)


def _build_slabs(spec, mesh, hyp_cov, X, mask, sW, jitter, b):
    """Shard i's dealt rows of B + jitter I (jitter on real rows only, the
    padded blocks stay exactly I): K(X_rows, X) scaled and masked in
    place, its rows of X gathered on its own device."""
    P = mesh.size
    rows = X.shape[0] // P
    slabs = []
    for i, (h, Xd, md, sWd) in enumerate(mesh.replicate(
            (hyp_cov, X, mask, sW), mesh.devices[0])):
        idx = dealt_rows(i, P, rows, b, Xd.device)
        slab = cov_matrix(spec, h, Xd.index_select(0, idx), Z=Xd)
        w = sWd * md
        slab.mul_(w.index_select(0, idx)[:, None]).mul_(w[None, :])
        _diagonal(slab, i, P, b).add_(
            (1.0 + jitter * md.index_select(0, idx)).view(-1, b))
        slabs.append(slab)
    return slabs


# The trailing update's multiply-adds issued a shard, counted on the host
# (index i: shard i); ``reset_update_macs`` empties it.
UPDATE_MACS = []


def reset_update_macs():
    del UPDATE_MACS[:]


def _below(p, n_shards, nr):
    """(shard, first local block) of every shard with rows below panel
    ``p``, ``nr`` local blocks a shard."""
    return [(s, l0) for s in range(n_shards)
            for l0 in ((p - s) // n_shards + 1,) if l0 < nr]


def _cholesky(slabs, devices, b):
    """The blocked right-looking Cholesky of the dealt B, in place (module
    docstring).  Each slab ends holding its rows of the lower factor,
    zero above the diagonal.  Each step issues its copies between devices
    before the work that follows them: a copy runs on its source's stream,
    behind whatever that shard was given before."""
    P, rows = len(slabs), slabs[0].shape[0]
    nr = rows // b
    UPDATE_MACS.extend([0] * (P - len(UPDATE_MACS)))
    for p in range(P * nr):
        c0, c1 = p * b, (p + 1) * b
        o, lo = p % P, p // P * b
        blk = slabs[o][lo : lo + b, c0:c1]
        Ljj, info = torch.linalg.cholesky_ex(blk)
        Ljj = torch.where(info == 0, Ljj, torch.full_like(Ljj, math.nan))
        blk.copy_(Ljj)
        below = [(s, l0, move(Ljj, devices[s], devices[o]))
                 for s, l0 in _below(p, P, nr)]
        # L_ij = A_ij L_jj^-T: the panel solve, in place.
        panel = {}
        for s, l0, Ljj_s in below:
            col = slabs[s][l0 * b :, c0:c1]
            sol = torch.linalg.solve_triangular(Ljj_s.mT, col, upper=True,
                                                left=False)
            col.copy_(sol)
            panel[s] = (l0, sol)
        # Each shard gathers every shard's solved blocks in global order,
        # from round r1, the round of panel p + 1, on: W (rows, b), whose
        # row c - base is global row c.
        r1 = c1 // (P * b)
        base = r1 * P * b
        W = {}
        for s, _, _ in below:
            G = panel[s][1].new_empty((nr - r1, P, b, b))
            for t, (l0, sol) in panel.items():
                G[l0 - r1 :, t] = move(sol, devices[s], devices[t]).view(
                    -1, b, b)
            W[s] = G.view(-1, b)
        for s, l0, _ in below:
            sol = panel[s][1]
            for l in range(l0, nr):
                c2 = (l * P + s + 1) * b
                k = (l - l0) * b
                slabs[s][l * b : (l + 1) * b, c1:c2].addmm_(
                    sol[k : k + b], W[s][c1 - base : c2 - base].mT,
                    alpha=-1.0)
                UPDATE_MACS[s] += b * (c2 - c1) * b
    for s, slab in enumerate(slabs):
        for l in range(nr):
            slab[l * b : (l + 1) * b, (l * P + s) * b :].tril_()
    return slabs


def _solve_lower(slabs, devices, b, rhs):
    """Forward substitution L z = rhs over the dealt L and rhs (lists of
    the shards' blocks); returns z's blocks."""
    P, rows = len(slabs), slabs[0].shape[0]
    nr = rows // b
    z = [r.clone() for r in rhs]
    for p in range(P * nr):
        c0, c1 = p * b, (p + 1) * b
        o, lo = p % P, p // P * b
        zj = torch.linalg.solve_triangular(
            slabs[o][lo : lo + b, c0:c1], z[o][lo : lo + b], upper=False)
        z[o][lo : lo + b] = zj
        below = [(s, l0 * b, move(zj, devices[s], devices[o]))
                 for s, l0 in _below(p, P, nr)]
        for s, r0, zj_s in below:
            z[s][r0:].addmm_(slabs[s][r0:, c0:c1], zj_s, alpha=-1.0)
    return z


def _solve_upper(slabs, devices, b, rhs):
    """Backward substitution L^T x = rhs over the dealt L and rhs; each
    shard's share of a block, L_sj^T x_s, is summed on the block's owner.
    Returns x's blocks."""
    P, rows = len(slabs), slabs[0].shape[0]
    nr = rows // b
    x = [torch.zeros_like(r) for r in rhs]
    for p in reversed(range(P * nr)):
        c0, c1 = p * b, (p + 1) * b
        o, lo = p % P, p // P * b
        blk = rhs[o][lo : lo + b]
        below = _below(p, P, nr)
        if below:
            blk = blk - psum(
                [move(slabs[s][l0 * b :, c0:c1].mT @ x[s][l0 * b :],
                      devices[o], devices[s]) for s, l0 in below], devices[o])
        x[o][lo : lo + b] = torch.linalg.solve_triangular(
            slabs[o][lo : lo + b, c0:c1].mT, blk, upper=True)
    return x


class DistExactPosterior:
    """A row-sharded exact posterior, made by :func:`dist_exact_fit` and
    served by :func:`dist_exact_predict`, in the dealt layout (module
    docstring): ``slabs[i]`` (rows, Np), on ``mesh.devices[i]``, holds the
    rows ``shard_rows(i)`` of the lower Cholesky factor of B, panel
    l P + i as its local block l, and ``alphas[i]`` (rows, 1) the same
    rows of alpha, on the first shard's device; ``X`` (Np, D) the padded
    inputs and ``sW`` (Np,) there too, in global row order; ``nlml`` the
    exact negative log marginal likelihood, a 0-d tensor there."""

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

    def shard_rows(self, i):
        """The global rows that shard ``i`` holds, in the order of its
        slab's rows and of ``alphas[i]``, on the first shard's device."""
        P = self.mesh.size
        return dealt_rows(i, P, self.Np // P, self.b, self.mesh.devices[0])

    @property
    def alpha(self):
        """alpha (Np, 1) in global row order on the first shard's device
        (the padded rows are exactly 0)."""
        rows = torch.cat([self.shard_rows(i) for i in range(self.mesh.size)])
        parts = torch.cat(self.alphas)
        return torch.empty_like(parts).index_copy_(0, rows, parts)


def _to_home(parts, devices):
    """The shards' parts moved to the first shard's device."""
    return [move(p, devices[0], d) for p, d in zip(parts, devices)]


def _hyp_tensor(hyp, X):
    return to_device("dist_hyp", np.asarray(hyp, dtype=np.float64), X.dtype,
                     X.device)


def _data(a, device, dtype=None):
    """``a`` (numpy or a tensor) as a tensor on ``device``, in ``dtype``
    or its own; a copy from the host is the sync ``dist_data``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return to_device("dist_data", a, dtype or a.dtype, device)


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
    A shard holds one (N / P, N) slab, the panels dealt to it.  ``jitter``
    is added to the unit diagonal of the real rows (B's eigenvalues are
    >= 1, so 0 is the default).  ``algorithm`` is "masked_full" or
    "two_level", the JAX package's two loops, which compute the same
    factor here (module docstring).  ``X`` (numpy or a tensor) sets the
    dtype.  Output warping is refused.  ``timings``, when a dict, adds the
    seconds of the build and factorization (``"factor_s"``) and of the
    solves and the NLML (``"solve_s"``), each ended by synchronizing the
    mesh's devices (``tracing.phase``: the spans ``gpyreg.fit.factor`` and
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
    X = _data(X, home)
    y = _data(y, home, X.dtype)
    N, P = X.shape[0], mesh.size
    b = min(int(b), max(32, N // P))
    Np, rows, _ = plan(N, P, b)
    X = _pad_rows(X, Np)
    y = _pad_rows(y, Np, 0.0)
    if s2 is not None:
        s2 = _pad_rows(_data(s2, home, X.dtype), Np, 1.0)
    devices = mesh.devices
    with torch.no_grad():
        with phase(timings, "factor_s"):
            hyp_cov, mask, sW, r, log_sn2_sum = _scaled_model(
                spec, _hyp_tensor(hyp, X), X, y, s2, N)
            with span("gpyreg.dist.build"):
                slabs = _build_slabs(spec, mesh, hyp_cov, X, mask, sW,
                                     float(jitter), b)
            with span("gpyreg.dist.cholesky"):
                slabs = _cholesky(slabs, devices, b)
            if timings is not None:
                _synchronize(mesh)
        with phase(timings, "solve_s"):
            dealt = [dealt_rows(i, P, rows, b, home) for i in range(P)]
            sW_r = sW * r[:, 0]
            sW_r = [move(sW_r.index_select(0, idx)[:, None], d, home)
                    for idx, d in zip(dealt, devices)]
            with span("gpyreg.dist.solve_lower"):
                z = _solve_lower(slabs, devices, b, sW_r)
            with span("gpyreg.dist.solve_upper"):
                x = _solve_upper(slabs, devices, b, z)
            with span("gpyreg.dist.nlml"):
                alphas = [sW.index_select(0, idx)[:, None]
                          * move(xi, home, d)
                          for idx, d, xi in zip(dealt, devices, x)]
                quad = psum(_to_home([torch.sum(zi * zi) for zi in z],
                                     devices), home)
                logdet_half = psum(_to_home(
                    [torch.sum(torch.log(_diagonal(slab, i, P, b)))
                     for i, slab in enumerate(slabs)], devices), home)
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
    mesh = post.mesh
    home, dtype = mesh.devices[0], post.X.dtype
    xs = _data(xs, home, dtype)
    xs = xs.reshape(-1, post.X.shape[1]) if xs.ndim < 2 else xs
    M = xs.shape[0]
    chunk = min(int(chunk), -(-M // 64) * 64)
    with torch.no_grad():
        hyp = _hyp_tensor(post.hyp, post.X)
        hyp_cov, _, hyp_mean = post.spec.split_hyp(hyp)
        real = (torch.arange(post.Np, device=home) < post.n_real).to(dtype)
        shards = []
        for i, (d, h) in enumerate(zip(mesh.devices,
                                       mesh.replicate(hyp_cov, home))):
            idx = post.shard_rows(i)
            shards.append((d, h, move(post.X.index_select(0, idx), d, home),
                           move(real.index_select(0, idx)[:, None], d, home),
                           move(post.sW.index_select(0, idx)[:, None], d,
                                home),
                           move(post.alphas[i], d, home)))
        mus, s2s = [], []
        for c in range(0, M, chunk):
            xc = _pad_rows(xs[c : c + chunk], chunk)
            xcs = [move(xc, d, home) for d, *_ in shards]
            Ks = [cov_matrix(post.spec, h, Xr, Z=xd).mul_(mr)
                  for (_, h, Xr, mr, _, _), xd in zip(shards, xcs)]
            mu = mean_value(post.spec, hyp_mean, xc) + psum(_to_home(
                [(K.T @ a)[:, 0] for (*_, a), K in zip(shards, Ks)],
                mesh.devices), home)
            with span("gpyreg.dist.solve_lower"):
                V = _solve_lower(post.slabs, mesh.devices, post.b,
                                 [sw * K for (*_, sw, _), K
                                  in zip(shards, Ks)])
            kss = cov_matrix(post.spec, hyp_cov, xc, diag=True)
            s2 = kss - psum(_to_home([torch.sum(v * v, dim=0) for v in V],
                                     mesh.devices), home)
            mus.append(mu)
            s2s.append(s2)
        mu = torch.cat(mus)[:M]
        s2 = torch.clamp(torch.cat(s2s)[:M], min=0.0)
    return mu.cpu().numpy(), s2.cpu().numpy()
