"""The plain reference of the configurations' model: an exact GP with an
ARD squared-exponential kernel, a constant mean and constant Gaussian
noise, written from the model's equations in plain PyTorch.

It imports nothing of ``gpyreg_tpu_torch``, ``gpyreg_tpu`` or JAX and
takes nothing the port made: every factor is worked out again from the
inputs X, y and the hyperparameter vectors
``[log ell (D), log sf, log sn, mean]``:

    K_ij = sf^2 exp(-|(x_i - x_j) / ell|^2 / 2),  G = K + mult sn^2 I,
    L = chol(G) (lower),  alpha = G^-1 (y - mean),

with mult = 1, raised tenfold (at most ten tries) only while the
factorization fails, as the configuration's model states.  Predictions:
mean + K*^T alpha and sf^2 - |L^-1 K*|^2 (floored at 0) per sample; the
mixture over S samples has the mean of the means and the mean of the
variances plus the samples' variance of the means (S - 1 in the
denominator).  The NLML is (y - m)^T alpha / 2 + sum log diag L +
N log(2 pi) / 2, and its gradient 0.5 tr((G^-1 - alpha alpha^T) dG/dtheta).

:class:`Precision` says how it computes: ``float64`` is the reference;
``tf32`` is the control, float32 tensors whose matrix products round
their operands to TF32 (the card's tensor cores with
``allow_tf32``; on the CPU the rounding is done explicitly).  Large
products and solves go in blocks of columns so that the float64 run fits
beside what is judged.
"""

import contextlib
import math

import torch

CHOL_TRIES = 10
BLOCK = 4096


def _round_tf32(a):
    """``a`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    def __init__(self, name):
        if name not in ("float64", "tf32"):
            raise ValueError(f"no precision {name}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    @contextlib.contextmanager
    def _tf32(self):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def mm(self, a, b):
        if self.name == "float64":
            return a @ b
        if a.is_cuda:
            with self._tf32():
                return a @ b
        return _round_tf32(a) @ _round_tf32(b)

    def tensor(self, a, device):
        return torch.as_tensor(a, dtype=self.dtype, device=device)


F64 = Precision("float64")
TF32 = Precision("tf32")


def split(hyp, D):
    """(ell (D,), sf2, sn2, mean) of one vector (a tensor)."""
    return (torch.exp(hyp[:D]), torch.exp(2 * hyp[D]), torch.exp(2 * hyp[D + 1]),
            hyp[D + 2])


def cross(hyp, X, Z, prec):
    """K(X, Z) of one vector, by the norm expansion of the scaled inputs
    (the products in ``prec``)."""
    D = X.shape[1]
    ell, sf2, _, _ = split(hyp, D)
    Xs, Zs = X / ell, Z / ell
    d2 = ((Xs * Xs).sum(1)[:, None] + (Zs * Zs).sum(1)[None, :]
          - 2.0 * prec.mm(Xs, Zs.T))
    return sf2 * torch.exp(-0.5 * torch.clamp(d2, min=0.0))


def gram(hyp, X, prec):
    """K(X, X), with its diagonal exactly sf^2."""
    K = cross(hyp, X, X, prec)
    K.diagonal().fill_(float(split(hyp, X.shape[1])[1]))
    return K


class Factor:
    """L = chol(G) lower, alpha, sn2 and the multiplier of one vector."""

    def __init__(self, hyp, X, y, prec):
        N, D = X.shape
        _, _, sn2, m = split(hyp, D)
        K = gram(hyp, X, prec)
        mult = 1.0
        for _ in range(CHOL_TRIES):
            G = K.clone()
            G.diagonal().add_(mult * sn2)
            L, info = torch.linalg.cholesky_ex(G)
            del G
            if int(info) == 0:
                break
            mult *= 10.0
        else:
            raise torch.linalg.LinAlgError("reference Cholesky failed")
        del K
        self.hyp, self.L, self.sn2, self.mult = hyp, L, sn2, mult
        self.alpha = torch.cholesky_solve(y - m, L)


def predict(fac, X, xs, prec):
    """Mean and variance (M,) of one sample at ``xs``, ``BLOCK`` points at
    a time."""
    D = X.shape[1]
    _, sf2, _, m = split(fac.hyp, D)
    mus, s2s = [], []
    for start in range(0, xs.shape[0], BLOCK):
        Ks = cross(fac.hyp, X, xs[start:start + BLOCK], prec)
        mus.append(m + prec.mm(Ks.T, fac.alpha)[:, 0])
        V = torch.linalg.solve_triangular(fac.L, Ks, upper=False)
        s2s.append(torch.clamp(sf2 - (V * V).sum(0), min=0.0))
        del Ks, V
    return torch.cat(mus), torch.cat(s2s)


def mixture(mus, s2s):
    """The S-sample mixture's mean and variance from (S, M) stacks."""
    S = mus.shape[0]
    mu = mus.mean(0)
    if S == 1:
        return mu, s2s[0]
    return mu, s2s.mean(0) + ((mus - mu) ** 2).sum(0) / (S - 1)


def predict_mixture(H, X, y, xs, prec):
    """Mixture mean and variance at ``xs`` over the vectors of ``H``
    (S, D + 3), each factorized in turn."""
    mus, s2s = [], []
    for h in H:
        fac = Factor(h, X, y, prec)
        mu, s2 = predict(fac, X, xs, prec)
        mus.append(mu)
        s2s.append(s2)
        del fac
    return mixture(torch.stack(mus), torch.stack(s2s))


def nlml_grad(hyp, X, y, prec):
    """NLML and its gradient in ``[log ell, log sf, log sn, mean]`` of one
    vector."""
    N, D = X.shape
    ell, sf2, sn2, m = split(hyp, D)
    fac = Factor(hyp, X, y, prec)
    r = y - m
    value = (0.5 * (r * fac.alpha).sum() + torch.log(fac.L.diagonal()).sum()
             + 0.5 * N * math.log(2 * math.pi))
    W = torch.cholesky_inverse(fac.L)
    a = fac.alpha[:, 0]
    W -= torch.outer(a, a)
    WK = W * gram(hyp, X, prec)
    rs = WK.sum(1)
    Xs = X / ell
    # sum_ij WK_ij (x_id - x_jd)^2 / 2 = sum_i x_id^2 rs_i - x_d^T WK x_d.
    g_ell = (Xs * Xs * rs[:, None]).sum(0) - (Xs * prec.mm(WK, Xs)).sum(0)
    g = torch.cat([g_ell, WK.sum().reshape(1),
                   (fac.mult * sn2 * W.diagonal().sum()).reshape(1),
                   (-a.sum()).reshape(1)])
    return value, g
