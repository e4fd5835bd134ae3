"""ARD covariance functions (API parity with reference
covariance_functions.py); the math runs through ``ops/kernels.py`` in
float64 on the CPU, and hyperparameter gradients come from forward-mode
autodiff (``torch.func.jacfwd``) instead of hand-derived ``dK``.

Port of ``gpyreg_tpu/covariance_functions.py``: ``_kind``, the
hyperparameter counts and info, ``compute``, and the recommended bounds
that ``GP.fit`` reads (``get_bounds_info`` and ``_bounds_info_helper``,
:88-92, :168-220; numpy on the host).
"""

import numpy as np
import torch

from .ops.kernels import kernel_matrix


def _validate_hyp(hyp, cov_N, kind="covariance"):
    if hyp.size != cov_N:
        raise ValueError(
            f"Expected {cov_N} {kind} function hyperparameters, "
            f"{hyp.size} passed instead."
        )
    if hyp.ndim != 1:
        raise ValueError(
            f"{kind.capitalize()} function output is available only for "
            "one-sample hyperparameter inputs."
        )


def _compute_kernel(kind, hyp, X, X_star, compute_diag, compute_grad):
    """Shared compute path for all kernel classes (numpy in, numpy out)."""
    hyp = torch.as_tensor(np.asarray(hyp, dtype=np.float64))
    X = torch.as_tensor(np.asarray(X, dtype=np.float64))
    if compute_grad and X_star is not None:
        raise ValueError("X_star should be None when compute_grad is True.")

    if X_star is None and compute_diag:
        if compute_grad:
            raise ValueError(
                "compute_grad with compute_diag is not supported."
            )
        # Reference returns the diagonal with shape (N, 1)
        # (covariance_functions.py:163-169).
        return kernel_matrix(kind, hyp, X, diag=True).numpy().reshape(-1, 1)

    Z = None
    if X_star is not None:
        Z = torch.as_tensor(np.asarray(X_star, dtype=np.float64))
    K = kernel_matrix(kind, hyp, X, Z=Z).numpy()

    if compute_grad:
        dK = torch.func.jacfwd(lambda h: kernel_matrix(kind, h, X))(hyp)
        return K, dK.numpy()  # (N, N, cov_N)
    return K


class AbstractKernel:
    """Base class for covariance kernels (reference
    covariance_functions.py:9-128); a subclass sets ``_kind``."""

    _kind: str = None

    def hyperparameter_count(self, D: int):
        """Number of hyperparameters (D lengthscales + 1 outputscale)."""
        return D + 1

    def hyperparameter_info(self, D: int):
        """Hyperparameter (name, count) pairs in storage order."""
        return [
            ("covariance_log_lengthscale", D),
            ("covariance_log_outputscale", 1),
        ]

    def compute(
        self,
        hyp: np.ndarray,
        X: np.ndarray,
        X_star: np.ndarray = None,
        compute_diag: bool = False,
        compute_grad: bool = False,
    ):
        """Compute the covariance matrix (and optionally its
        hyperparameter gradient of shape (N, N, cov_N))."""
        _validate_hyp(np.asarray(hyp), self.hyperparameter_count(X.shape[1]))
        return _compute_kernel(
            self._kind, hyp, X, X_star, compute_diag, compute_grad
        )

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        """Recommended bounds from data ranges (reference
        covariance_functions.py:424-463)."""
        cov_N = self.hyperparameter_count(X.shape[1])
        return _bounds_info_helper(cov_N, X, y)


class SquaredExponential(AbstractKernel):
    """Squared exponential ARD kernel."""

    _kind = "se"


class Matern(AbstractKernel):
    """Matern ARD kernel of degree 1, 3 or 5 (nu = degree/2)."""

    def __init__(self, degree: int):
        if degree not in (1, 3, 5):
            raise ValueError(
                "Only degrees 1, 3 and 5 are supported for the "
                "Matern covariance function."
            )
        self.degree = degree
        self._kind = f"m{degree}"


class RationalQuadraticARD(AbstractKernel):
    """Rational quadratic ARD kernel (extra log-shape hyperparameter)."""

    _kind = "rq"

    def hyperparameter_count(self, D: int):
        return D + 2

    def hyperparameter_info(self, D: int):
        return [
            ("covariance_log_lengthscale", D),
            ("covariance_log_outputscale", 1),
            ("covariance_log_shape", 1),
        ]

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        """Bounds including the log-shape init used by BADS (reference
        covariance_functions.py:369-421, including its quirk of setting
        PUB[D] = 5.0 for the outputscale)."""
        cov_N = self.hyperparameter_count(X.shape[1])
        info = _bounds_info_helper(cov_N, X, y, skip_tail=1)
        # covariance_log_shape slot
        info["LB"][-1] = -5.0
        info["UB"][-1] = 5.0
        info["PLB"][-1] = -5.0
        # Reference sets PUB at index D (outputscale), not -1; reproduced
        # for behavioral parity (covariance_functions.py:405).
        info["PUB"][X.shape[1]] = 5.0
        info["x0"][-1] = 1.0
        i_nan = np.isnan(info["x0"])
        info["x0"][i_nan] = 0.5 * (info["PLB"][i_nan] + info["PUB"][i_nan])
        return info


def _bounds_info_helper(cov_N, X, y, skip_tail=0):
    """Data-driven recommended bounds (reference
    covariance_functions.py:424-463): lengthscales bounded by data widths,
    outputscale by target range, with a tol=1e-6 soft floor."""
    _, D = X.shape
    tol = 1e-6
    LB = np.full((cov_N,), -np.inf)
    UB = np.full((cov_N,), np.inf)
    PLB = np.full((cov_N,), -np.inf)
    PUB = np.full((cov_N,), np.inf)
    x0 = np.full((cov_N,), np.nan)

    width = np.max(X, axis=0) - np.min(X, axis=0)
    if np.size(y) <= 1:
        y = np.array([0, 1])
    height = np.max(y) - np.min(y)

    LB[0:D] = np.log(width) + np.log(tol)
    UB[0:D] = np.log(width * 10)
    PLB[0:D] = np.log(width) + 0.5 * np.log(tol)
    PUB[0:D] = np.log(width)
    x0[0:D] = np.log(np.std(X, ddof=1))

    LB[D] = np.log(height) + np.log(tol)
    UB[D] = np.log(height * 10)
    PLB[D] = np.log(height) + 0.5 * np.log(tol)
    PUB[D] = np.log(height)
    x0[D] = np.log(np.std(y, ddof=1))

    if not skip_tail:
        i_nan = np.isnan(x0)
        x0[i_nan] = 0.5 * (PLB[i_nan] + PUB[i_nan])

    return {"LB": LB, "UB": UB, "PLB": PLB, "PUB": PUB, "x0": x0}
