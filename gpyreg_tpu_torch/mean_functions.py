"""GP mean functions (NumPy compute; the device path uses
``core/model.mean_value``).

Port of ``gpyreg_tpu/mean_functions.py``: the eight kinds that
``GP.load`` names (zero, constant, negative quadratic, and the gplite
oracle's linear, quadratic, positive quadratic and the (negative)
squared-exponential bumps) and :class:`CustomMean`, each with ``_kind``,
the hyperparameter counts and info, ``compute``, and the recommended
bounds that ``GP.fit`` reads (every ``get_bounds_info``,
``_bounds_info_helper``, ``_gplite_ranges`` and
``_custom_default_bounds``, :38-40, :68-70, :100-102, :126-187, :203-214,
:240-254, :280-300, :341-370, :466-504; numpy on the host).
"""

import numpy as np
import torch


def _validate_hyp(hyp, mean_N):
    if hyp.size != mean_N:
        raise ValueError(
            f"Expected {mean_N} mean function hyperparameters, "
            f"{hyp.size} passed instead."
        )
    if hyp.ndim != 1:
        raise ValueError(
            "Mean function output is available only for "
            "one-sample hyperparameter inputs."
        )


class ZeroMean:
    """Identically-zero mean function (0 hyperparameters)."""

    _kind = "zero"

    @staticmethod
    def hyperparameter_count(_):
        return 0

    @staticmethod
    def hyperparameter_info(_):
        return []

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        mean_N = self.hyperparameter_count(X.shape[1])
        return _bounds_info_helper(mean_N, X, y, 0)

    def compute(self, hyp, X, compute_grad: bool = False):
        N, D = X.shape
        _validate_hyp(np.asarray(hyp), self.hyperparameter_count(D))
        m = np.zeros((N,))
        if compute_grad:
            # Reference returns an empty gradient list here
            # (mean_functions.py:128-129).
            return m, []
        return m


class ConstantMean:
    """Constant mean function (1 hyperparameter: the constant)."""

    _kind = "const"

    @staticmethod
    def hyperparameter_count(_):
        return 1

    @staticmethod
    def hyperparameter_info(_):
        return [("mean_const", 1)]

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        mean_N = self.hyperparameter_count(X.shape[1])
        return _bounds_info_helper(mean_N, X, y, 1)

    def compute(self, hyp, X, compute_grad: bool = False):
        N, D = X.shape
        _validate_hyp(np.asarray(hyp), self.hyperparameter_count(D))
        m = hyp[0] * np.ones((N,))
        if compute_grad:
            return m, np.ones((N, 1))
        return m


class _QuadBowl:
    """m0 + sgn*0.5*sum(((x-xm)/omega)^2): 1 + 2D hyperparameters
    [m0, xm (D), log omega (D)] (reference mean_functions.py:263-397,
    gplite_meanfun.m case 'posquad')."""

    _sgn = -1.0

    @staticmethod
    def hyperparameter_count(D: int):
        return 1 + 2 * D

    @staticmethod
    def hyperparameter_info(D: int):
        return [("mean_const", 1), ("mean_location", D), ("mean_log_scale", D)]

    def compute(self, hyp, X, compute_grad: bool = False):
        N, D = X.shape
        hyp = np.asarray(hyp)
        mean_N = self.hyperparameter_count(D)
        _validate_hyp(hyp, mean_N)
        m0 = hyp[0]
        xm = hyp[1 : 1 + D]
        omega = np.exp(hyp[1 + D : 1 + 2 * D])
        z2 = ((X - xm) / omega) ** 2
        m = m0 + self._sgn * 0.5 * np.sum(z2, axis=1)
        if compute_grad:
            dm = np.zeros((N, mean_N))
            dm[:, 0] = 1.0
            dm[:, 1 : D + 1] = -self._sgn * (X - xm) / omega**2
            dm[:, D + 1 :] = -self._sgn * z2
            return m, dm
        return m


class NegativeQuadratic(_QuadBowl):
    """Centered negative quadratic mean: m0 - 0.5*sum(((x-xm)/omega)^2)."""

    _kind = "negquad"
    _sgn = -1.0

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        mean_N = self.hyperparameter_count(X.shape[1])
        return _bounds_info_helper(mean_N, X, y, 2)


class PositiveQuadratic(_QuadBowl):
    """m0 + 0.5*sum(((x-xm)/omega)^2) (gplite_meanfun.m case 'posquad')."""

    _kind = "posquad"
    _sgn = 1.0

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        tol, big = 1e-6, np.exp(3)
        w, h, y = _gplite_ranges(X, y)
        LB = np.concatenate(
            [[np.min(y) - h], np.min(X, axis=0) - 0.5 * w,
             np.log(w) + np.log(tol)]
        )
        UB = np.concatenate(
            [[np.max(y)], np.max(X, axis=0) + 0.5 * w,
             np.log(w) + np.log(big)]
        )
        PLB = np.concatenate(
            [[np.min(y)], np.min(X, axis=0), np.log(w) + 0.5 * np.log(tol)]
        )
        PUB = np.concatenate([[np.median(y)], np.max(X, axis=0), np.log(w)])
        x0 = np.concatenate(
            [[np.quantile(y, 0.1)], np.median(X, axis=0),
             np.log(np.std(X, axis=0, ddof=1))]
        )
        return {"LB": LB, "UB": UB, "PLB": PLB, "PUB": PUB, "x0": x0}


def _bounds_info_helper(mean_N, X, y, idx):
    """Recommended bounds per mean kind (reference
    mean_functions.py:400-459).  ``idx``: 0 zero, 1 constant, 2 negquad.
    Uses the global (not per-dim) data range, matching the reference."""
    _, D = X.shape
    tol = 1e-6
    big = np.exp(3)
    LB = np.full((mean_N,), -np.inf)
    UB = np.full((mean_N,), np.inf)
    PLB = np.full((mean_N,), -np.inf)
    PUB = np.full((mean_N,), np.inf)
    x0 = np.full((mean_N,), np.nan)

    w = np.max(X) - np.min(X)
    if np.size(y) <= 1:
        y = np.array([0, 1])
    h = np.max(y) - np.min(y)

    if idx == 1:
        LB[0] = np.min(y) - 0.5 * h
        UB[0] = np.max(y) + 0.5 * h
        PLB[0] = np.quantile(y, 0.1)
        PUB[0] = np.quantile(y, 0.9)
        x0[0] = np.median(y)
    elif idx == 2:
        LB[0] = np.min(y)
        UB[0] = np.max(y) + h
        PLB[0] = np.median(y)
        PUB[0] = np.max(y)
        x0[0] = np.quantile(y, 0.9)

        LB[1 : 1 + D] = np.min(X) - 0.5 * w
        UB[1 : 1 + D] = np.max(X) + 0.5 * w
        PLB[1 : 1 + D] = np.min(X)
        PUB[1 : 1 + D] = np.max(X)
        x0[1 : 1 + D] = np.median(X)

        LB[1 + D : mean_N] = np.log(w) + np.log(tol)
        UB[1 + D : mean_N] = np.log(w) + np.log(big)
        PLB[1 + D : mean_N] = np.log(w) + 0.5 * np.log(tol)
        PUB[1 + D : mean_N] = np.log(w)
        x0[1 + D : mean_N] = np.log(np.std(X, ddof=1))

    i_nan = np.isnan(x0)
    x0[i_nan] = 0.5 * (PLB[i_nan] + PUB[i_nan])

    return {"LB": LB, "PLB": PLB, "UB": UB, "PUB": PUB, "x0": x0}


def _gplite_ranges(X, y):
    """Per-dimension data widths and the target range
    (gplite_meanfun.m:140-246)."""
    w = np.max(X, axis=0) - np.min(X, axis=0)
    if np.size(y) <= 1:
        y = np.array([0, 1])
    h = np.max(y) - np.min(y)
    return w, h, y


class LinearMean:
    """m0 + a.x (1 + D hyperparameters; gplite_meanfun.m case 'linear')."""

    _kind = "linear"

    @staticmethod
    def hyperparameter_count(D: int):
        return 1 + D

    @staticmethod
    def hyperparameter_info(D: int):
        return [("mean_const", 1), ("mean_linear", D)]

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        D = X.shape[1]
        big = np.exp(3)
        w, h, y = _gplite_ranges(X, y)
        delta = w / h
        LB = np.concatenate([[np.min(y) - 0.5 * h], -delta * big])
        UB = np.concatenate([[np.max(y) + 0.5 * h], delta * big])
        PLB = np.concatenate([[np.quantile(y, 0.1)], -delta])
        PUB = np.concatenate([[np.quantile(y, 0.9)], delta])
        x0 = np.concatenate([[np.median(y)], np.zeros(D)])
        return {"LB": LB, "UB": UB, "PLB": PLB, "PUB": PUB, "x0": x0}

    def compute(self, hyp, X, compute_grad: bool = False):
        N, D = X.shape
        hyp = np.asarray(hyp)
        _validate_hyp(hyp, self.hyperparameter_count(D))
        m = hyp[0] + X @ hyp[1 : 1 + D]
        if compute_grad:
            return m, np.concatenate([np.ones((N, 1)), X], axis=1)
        return m


class QuadraticMean:
    """m0 + a.x + b.x^2 (1 + 2D hyp; gplite_meanfun.m case 'quad')."""

    _kind = "quad"

    @staticmethod
    def hyperparameter_count(D: int):
        return 1 + 2 * D

    @staticmethod
    def hyperparameter_info(D: int):
        return [("mean_const", 1), ("mean_linear", D), ("mean_quadratic", D)]

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        D = X.shape[1]
        big = np.exp(3)
        w, h, y = _gplite_ranges(X, y)
        delta = w / h
        LB = np.concatenate(
            [[np.min(y) - 0.5 * h], -delta * big, -((delta * big) ** 2)]
        )
        UB = np.concatenate(
            [[np.max(y) + 0.5 * h], delta * big, (delta * big) ** 2]
        )
        PLB = np.concatenate([[np.quantile(y, 0.1)], -delta, -(delta**2)])
        PUB = np.concatenate([[np.quantile(y, 0.9)], delta, delta**2])
        x0 = np.concatenate([[np.median(y)], np.zeros(2 * D)])
        return {"LB": LB, "UB": UB, "PLB": PLB, "PUB": PUB, "x0": x0}

    def compute(self, hyp, X, compute_grad: bool = False):
        N, D = X.shape
        hyp = np.asarray(hyp)
        _validate_hyp(hyp, self.hyperparameter_count(D))
        m = hyp[0] + X @ hyp[1 : 1 + D] + (X**2) @ hyp[1 + D : 1 + 2 * D]
        if compute_grad:
            return m, np.concatenate([np.ones((N, 1)), X, X**2], axis=1)
        return m


class _SEMeanBase:
    """The (negative) squared-exponential bump means (gplite_meanfun.m
    cases 'se'/'negse', 2 + 2D hyperparameters:
    [m0, xm (D), log omega (D), log h])."""

    _sgn = 1.0

    @staticmethod
    def hyperparameter_count(D: int):
        return 2 + 2 * D

    @staticmethod
    def hyperparameter_info(D: int):
        return [
            ("mean_const", 1),
            ("mean_location", D),
            ("mean_log_scale", D),
            ("mean_log_height", 1),
        ]

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        tol, big = 1e-6, np.exp(3)
        w, h, y = _gplite_ranges(X, y)
        if self._sgn > 0:  # 'se': bump above baseline, m0 near the bottom
            m0_b = (np.min(y) - h, np.max(y), np.min(y), np.median(y),
                    np.quantile(y, 0.1))
        else:  # 'negse': dip below baseline, m0 near the top
            m0_b = (np.min(y), np.max(y) + h, np.median(y), np.max(y),
                    np.quantile(y, 0.9))
        LB = np.concatenate(
            [[m0_b[0]], np.min(X, axis=0) - 0.5 * w,
             np.log(w) + np.log(tol), [np.log(h) + np.log(tol)]]
        )
        UB = np.concatenate(
            [[m0_b[1]], np.max(X, axis=0) + 0.5 * w,
             np.log(w) + np.log(big), [np.log(h) + np.log(big)]]
        )
        PLB = np.concatenate(
            [[m0_b[2]], np.min(X, axis=0),
             np.log(w) + 0.5 * np.log(tol), [np.log(h) + 0.5 * np.log(tol)]]
        )
        PUB = np.concatenate(
            [[m0_b[3]], np.max(X, axis=0), np.log(w), [np.log(h)]]
        )
        x0 = np.concatenate(
            [[m0_b[4]], np.median(X, axis=0),
             np.log(np.std(X, axis=0, ddof=1)), [np.log(np.std(y, ddof=1))]]
        )
        return {"LB": LB, "UB": UB, "PLB": PLB, "PUB": PUB, "x0": x0}

    def compute(self, hyp, X, compute_grad: bool = False):
        N, D = X.shape
        hyp = np.asarray(hyp)
        mean_N = self.hyperparameter_count(D)
        _validate_hyp(hyp, mean_N)
        m0 = hyp[0]
        xm = hyp[1 : 1 + D]
        omega = np.exp(hyp[1 + D : 1 + 2 * D])
        hgt = np.exp(hyp[1 + 2 * D])
        z2 = ((X - xm) / omega) ** 2
        se = self._sgn * hgt * np.exp(-0.5 * np.sum(z2, axis=1))
        m = m0 + se
        if compute_grad:
            dm = np.zeros((N, mean_N))
            dm[:, 0] = 1.0
            dm[:, 1 : D + 1] = (X - xm) / omega**2 * se[:, None]
            dm[:, D + 1 : 1 + 2 * D] = z2 * se[:, None]
            dm[:, 1 + 2 * D] = se
            return m, dm
        return m


class SquaredExponentialMean(_SEMeanBase):
    """m0 + h*exp(-0.5*sum(((x-xm)/omega)^2)) ('se')."""

    _kind = "se_mean"
    _sgn = 1.0


class NegativeSquaredExponentialMean(_SEMeanBase):
    """m0 - h*exp(-0.5*sum(((x-xm)/omega)^2)) ('negse')."""

    _kind = "negse_mean"
    _sgn = -1.0


class CustomMean:
    """User-supplied mean function.

    Parameters
    ----------
    value_fn : callable
        ``value_fn(hyp_mean, X) -> (N,)`` over torch tensors
        (``hyp_mean`` is the mean's slice of the flat hyp vector).
        Gradients come from autodiff (``torch.func.jacfwd``).
    hyp_count : int or callable
        Number of mean hyperparameters, or ``D -> int``.
    name : str, optional
        Registry key (defaults to the callable's qualified name); re-using
        a name for a *different* callable raises.
    bounds_info_fn : callable, optional
        ``(X, y) -> {"LB","PLB","UB","PUB","x0"}`` override.  The
        default recommends a finite data-driven box for every
        hyperparameter, so ``GP.fit``'s NaN-fill and space-filling
        design work out of the box.
    hyp_info : list[(str, int)], optional
        Hyperparameter-name groups for the dict ABI (default one group
        ``("mean_custom", hyp_count)``).
    """

    def __init__(
        self,
        value_fn,
        hyp_count,
        name: str = None,
        bounds_info_fn=None,
        hyp_info=None,
    ):
        from .core.model import register_custom_mean

        if name is None:
            name = getattr(value_fn, "__qualname__", None) or getattr(
                value_fn, "__name__", "anonymous"
            )
        self._name = name
        self._value_fn = value_fn
        self._count = (
            hyp_count if callable(hyp_count) else (lambda D: int(hyp_count))
        )
        self._bounds_info_fn = bounds_info_fn
        self._hyp_info = hyp_info
        self._kind = register_custom_mean(name, value_fn, self._count)

    def hyperparameter_count(self, D: int):
        return self._count(D)

    def hyperparameter_info(self, D: int):
        if self._hyp_info is not None:
            return list(self._hyp_info)
        return [("mean_custom", self._count(D))]

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        if self._bounds_info_fn is not None:
            return self._bounds_info_fn(X, y)
        mean_N = self._count(X.shape[1])
        return _custom_default_bounds(mean_N, X, y)

    def compute(self, hyp, X, compute_grad: bool = False):
        N, D = X.shape
        mean_N = self._count(D)
        _validate_hyp(np.asarray(hyp), mean_N)
        h = torch.as_tensor(np.asarray(hyp, dtype=np.float64))
        Xt = torch.as_tensor(np.asarray(X, dtype=np.float64))

        def value(h):
            return torch.reshape(self._value_fn(h, Xt), (N,))

        m = value(h).detach().numpy()
        if compute_grad:
            dm = torch.func.jacfwd(value)(h).numpy()
            return m, dm.reshape(N, mean_N)
        return m


def _custom_default_bounds(mean_N, X, y):
    """Generic finite recommended box for custom-mean hyperparameters:
    the constant-mean y-range heuristic applied to every hyperparameter
    (reference mean_functions.py:400-459, idx=1 branch)."""
    if np.size(y) <= 1:
        y = np.array([0, 1])
    h = np.max(y) - np.min(y)
    LB = np.full((mean_N,), np.min(y) - 10.0 * max(h, 1.0))
    UB = np.full((mean_N,), np.max(y) + 10.0 * max(h, 1.0))
    PLB = np.full((mean_N,), np.min(y) - 0.5 * max(h, 1.0))
    PUB = np.full((mean_N,), np.max(y) + 0.5 * max(h, 1.0))
    x0 = np.full((mean_N,), float(np.median(y)))
    return {"LB": LB, "PLB": PLB, "UB": UB, "PUB": PUB, "x0": x0}
