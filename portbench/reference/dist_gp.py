"""The plain reference of the row-sharded exact GP (``dist131k``): the
NLML, alpha and the predictive moments of an exact GP with an ARD
squared-exponential kernel, a constant mean and constant Gaussian noise,
by a tile Cholesky spread over the cell's devices.

It imports only ``torch``, ``numpy`` and the standard library, nothing of
``gpyreg_tpu_torch``, ``gpyreg_tpu`` or JAX, and takes nothing the port
made: every factor is worked out again from X, y and the vector
``[log ell (D), log sf, log sn, mean]``.  At N = 131,072 the dense
float64 K of ``reference/gp.py`` would be 137 GB, more than a card holds,
so this file departs from that one's dense formulas, and only so:

- It factors B = I + sW K sW with sW = 1 / sn (the noise is constant),
  as the port does, not G = K + sn^2 I.  G = sn^2 B, so with L the lower
  factor of B and z = L^-1 (sW r), r = y - mean:
  NLML = |z|^2 / 2 + sum log diag L + N log sn^2 / 2 + N log(2 pi) / 2,
  alpha = G^-1 r = sW L^-T z; the numbers of ``gp.py``'s ``nlml_grad``
  and ``Factor.alpha``.
- B's eigenvalues are at least 1, so its factorization does not fail and
  no noise multiplier is raised (``gp.py``'s ``CHOL_TRIES``): a failed
  tile raises.
- K is never whole.  Only the lower triangle of B is held, in T x T tiles
  (the last row and column of tiles ragged), dealt round-robin, in
  row-major order over the lower triangle, to the devices: at N =
  131,072 and T = 8,192, 136 tiles of 0.54 GB in float64, 73 GB over
  four cards.  Each tile K(X_i, X_j) is built on its device by
  ``gp.py``'s norm expansion, a diagonal tile's diagonal set to sf^2
  exactly.
- The factorization is right-looking by tile columns: potrf of the
  diagonal tile, trsm of the tiles below it, then each trailing tile
  less the product of its two column tiles (syrk on the diagonal, gemm
  below), on the device of the tile it updates.  The port instead
  factors block rows of B by panels of width b; the two share no code.
- The substitutions and the predictive variance go tile by tile, each
  product on its tile's device.

Precision: ``prec`` is ``gp.py``'s ``F64`` or ``TF32`` (or their names).
``float64`` is the reference; ``tf32`` is the control, float32 tensors
whose matrix products round their operands to TF32 (the card's tensor
cores, on the CPU explicitly).  The reference sets
``torch.backends.cuda.matmul.allow_tf32`` itself while it runs: True for
the control, False for float64.
"""

import contextlib
import math

import numpy as np
import torch

TILE = 8192


def tile_for(n):
    """The tile side for n rows: ``TILE``, or n / 8 (at least 64) where
    that is smaller, so that a small n still crosses several tiles."""
    return min(TILE, max(64, -(-n // 8)))


def _round_tf32(a):
    """``a`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Prec:
    def __init__(self, prec):
        self.name = getattr(prec, "name", prec)
        if self.name not in ("float64", "tf32"):
            raise ValueError(f"no precision {self.name}")
        self.dtype = torch.float64 if self.name == "float64" else torch.float32

    @contextlib.contextmanager
    def products(self):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.name == "tf32"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def _operands(self, a, b):
        if self.name == "tf32" and not a.is_cuda:
            return _round_tf32(a), _round_tf32(b)
        return a, b

    def mm(self, a, b):
        a, b = self._operands(a, b)
        return a @ b

    def sub_mm_(self, c, a, b):
        """c -= a @ b, in place."""
        a, b = self._operands(a, b)
        return c.addmm_(a, b, alpha=-1.0)


class Tiles:
    """The lower triangle of an (n, n) matrix in T x T tiles: tile (i, j),
    j <= i, covers rows ``rows(i)`` and columns ``rows(j)`` and lives on
    ``owner(i, j)``, the devices dealt round-robin in row-major order."""

    def __init__(self, n, tile, devices):
        self.n, self.T, self.devices = n, int(tile), list(devices)
        self.nt = -(-n // self.T)
        self.blocks = {}

    def rows(self, i):
        return slice(i * self.T, min((i + 1) * self.T, self.n))

    def owner(self, i, j):
        return self.devices[(i * (i + 1) // 2 + j) % len(self.devices)]


def _split(hyp, D):
    """(ell (D,), sf2, sn2, mean) of one vector (a tensor)."""
    return (torch.exp(hyp[:D]), torch.exp(2 * hyp[D]),
            torch.exp(2 * hyp[D + 1]), hyp[D + 2])


def _cross(Xs, Zs, sf2, prec):
    """sf2 exp(-|xs - zs|^2 / 2) of pre-scaled rows, by the norm
    expansion with the product in ``prec``."""
    d2 = ((Xs * Xs).sum(1)[:, None] + (Zs * Zs).sum(1)[None, :]
          - 2.0 * prec.mm(Xs, Zs.T))
    return sf2 * torch.exp(-0.5 * torch.clamp(d2, min=0.0))


class _Copies:
    """Each tile needed on a device, copied there once."""

    def __init__(self, tiles):
        self.tiles, self.held = tiles, {}

    def get(self, key, device):
        if (key, device) not in self.held:
            self.held[(key, device)] = self.tiles.blocks[key].to(device)
        return self.held[(key, device)]


class TileFactor:
    """The tile Cholesky of B for one hyperparameter vector, with the
    NLML (``nlml``, a float) and alpha (``alpha``, (N,) float64 numpy).
    ``hyp``, ``X`` (N, D) and ``y`` (N, 1) are host arrays; ``devices``
    the cell's devices (repeats allowed); ``tile`` the tile side
    (:func:`tile_for` when None)."""

    def __init__(self, hyp, X, y, prec, devices, tile=None):
        self.prec = _Prec(prec)
        dt = self.prec.dtype
        N, D = np.shape(X)
        self.home = torch.device(devices[0])
        t = lambda a, d=self.home: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=d)
        ell, sf2, sn2, m = _split(t(hyp), D)
        self.ell, self.sf2, self.sn2, self.m = ell, sf2, sn2, m
        self.L = Tiles(N, tile or tile_for(N),
                       [torch.device(d) for d in devices])
        # The scaled inputs on each device, once.
        self.Xs = {d: t(X, d) / ell.to(d) for d in set(self.L.devices)}
        with torch.no_grad(), self.prec.products():
            self._factor()
            r = (t(y)[:, 0] - m) / torch.sqrt(sn2)
            z = self.solve_lower(r[:, None])
            x = self.solve_upper(z)
            logdet_half = sum(
                torch.log(self.L.blocks[(i, i)].diagonal()).sum().to(
                    self.home) for i in range(self.L.nt))
            nlml = (0.5 * (z * z).sum() + logdet_half
                    + 0.5 * N * torch.log(sn2) + 0.5 * N * math.log(2 * math.pi))
            self.nlml = float(nlml)
            self.alpha = (x[:, 0] / torch.sqrt(sn2)).double().cpu().numpy()

    def _factor(self):
        L, prec = self.L, self.prec
        sf2 = {d: self.sf2.to(d) for d in self.Xs}
        sn2 = {d: self.sn2.to(d) for d in self.Xs}
        for i in range(L.nt):
            for j in range(i + 1):
                d = L.owner(i, j)
                Xs = self.Xs[d]
                B = _cross(Xs[L.rows(i)], Xs[L.rows(j)], sf2[d], prec)
                if i == j:
                    B.diagonal().fill_(sf2[d])
                B.div_(sn2[d])
                if i == j:
                    B.diagonal().add_(1.0)
                L.blocks[(i, j)] = B
        infos = []
        for k in range(L.nt):
            Lkk, info = torch.linalg.cholesky_ex(L.blocks[(k, k)])
            L.blocks[(k, k)] = Lkk
            infos.append(info.to(self.home))
            col = _Copies(L)
            for i in range(k + 1, L.nt):
                L.blocks[(i, k)] = torch.linalg.solve_triangular(
                    col.get((k, k), L.owner(i, k)).mT, L.blocks[(i, k)],
                    upper=True, left=False)
            for i in range(k + 1, L.nt):
                for j in range(k + 1, i + 1):
                    d = L.owner(i, j)
                    prec.sub_mm_(L.blocks[(i, j)], col.get((i, k), d),
                                 col.get((j, k), d).mT)
            del col
        if int(torch.stack(infos).abs().sum()) != 0:
            raise torch.linalg.LinAlgError("reference tile Cholesky failed")

    def solve_lower(self, v):
        """L^-1 v for v (N, m) on the first device; returns the same."""
        L, prec = self.L, self.prec
        z = []
        for i in range(L.nt):
            acc = v[L.rows(i)]
            for j in range(i):
                d = L.owner(i, j)
                acc = acc - prec.mm(L.blocks[(i, j)], z[j].to(d)).to(self.home)
            d = L.owner(i, i)
            z.append(torch.linalg.solve_triangular(
                L.blocks[(i, i)], acc.to(d), upper=False).to(self.home))
        return torch.cat(z)

    def solve_upper(self, v):
        """L^-T v for v (N, m) on the first device; returns the same."""
        L, prec = self.L, self.prec
        x = [None] * L.nt
        for i in reversed(range(L.nt)):
            acc = v[L.rows(i)]
            for j in range(i + 1, L.nt):
                d = L.owner(j, i)
                acc = acc - prec.mm(L.blocks[(j, i)].mT,
                                    x[j].to(d)).to(self.home)
            d = L.owner(i, i)
            x[i] = torch.linalg.solve_triangular(
                L.blocks[(i, i)].mT, acc.to(d), upper=True).to(self.home)
        return torch.cat(x)

    def predict(self, xs):
        """Latent mean and variance (M,) at ``xs`` (M, D), float64 numpy:
        mean + K*^T alpha and sf^2 - |L^-1 sW K*|^2, floored at 0."""
        prec = self.prec
        with torch.no_grad(), prec.products():
            xs = torch.as_tensor(np.asarray(xs), dtype=prec.dtype,
                                 device=self.home) / self.ell
            Ks = _cross(self.Xs[self.home], xs, self.sf2, prec)
            alpha = torch.as_tensor(self.alpha, dtype=prec.dtype,
                                    device=self.home)
            mu = self.m + prec.mm(Ks.T, alpha[:, None])[:, 0]
            V = self.solve_lower(Ks / torch.sqrt(self.sn2))
            s2 = torch.clamp(self.sf2 - (V * V).sum(0), min=0.0)
        return mu.double().cpu().numpy(), s2.double().cpu().numpy()

    def release(self):
        """Drop the tiles (every device's memory they hold)."""
        self.L.blocks.clear()
        self.Xs = {}
