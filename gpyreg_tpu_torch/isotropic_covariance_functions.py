"""Isotropic covariance functions: a single shared lengthscale (2
hyperparameters regardless of D), computed through the ``*_iso`` kernel
kinds of ``ops/kernels.py``.

Port of ``gpyreg_tpu/isotropic_covariance_functions.py``: ``_kind``, the
hyperparameter counts and info, ``compute``, and the recommended bounds
(:30-32, :75-108).
"""

import numpy as np

from .covariance_functions import AbstractKernel, Matern, SquaredExponential


class AbstractIsotropicKernel(AbstractKernel):
    """Base for isotropic kernels: log-lengthscale + log-outputscale."""

    def hyperparameter_count(self, D: int):
        return 2

    def hyperparameter_info(self, D: int):
        return [
            ("covariance_log_lengthscale", 1),
            ("covariance_log_outputscale", 1),
        ]

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        cov_N = self.hyperparameter_count(X.shape[1])
        return _isotropic_bounds_info_helper(cov_N, X, y)


class MaternIsotropic(AbstractIsotropicKernel, Matern):
    """Isotropic Matern kernel of degree 1, 3 or 5."""

    def __init__(self, degree: int):
        Matern.__init__(self, degree)
        self._kind = f"m{degree}_iso"


class SquaredExponentialIsotropic(AbstractIsotropicKernel, SquaredExponential):
    """Isotropic squared exponential kernel."""

    _kind = "se_iso"


def _isotropic_bounds_info_helper(cov_N, X, y):
    """Recommended bounds for isotropic kernels (reference
    isotropic_covariance_functions.py:224-267): the lengthscale bound uses
    the mean data width across dimensions."""
    tol = 1e-6
    LB = np.full((cov_N,), -np.inf)
    UB = np.full((cov_N,), np.inf)
    PLB = np.full((cov_N,), -np.inf)
    PUB = np.full((cov_N,), np.inf)
    x0 = np.full((cov_N,), np.nan)

    width = np.mean(np.max(X, axis=0) - np.min(X, axis=0))
    if np.size(y) <= 1:
        y = np.array([0, 1])
    height = np.max(y) - np.min(y)

    LB[0 : cov_N - 1] = np.log(width) + np.log(tol)
    UB[0 : cov_N - 1] = np.log(width * 10)
    PLB[0 : cov_N - 1] = np.log(width) + 0.5 * np.log(tol)
    PUB[0 : cov_N - 1] = np.log(width)
    x0[0 : cov_N - 1] = np.log(np.std(X, ddof=1))

    LB[cov_N - 1] = np.log(height) + np.log(tol)
    UB[cov_N - 1] = np.log(height * 10)
    PLB[cov_N - 1] = np.log(height) + 0.5 * np.log(tol)
    PUB[cov_N - 1] = np.log(height)
    x0[cov_N - 1] = np.log(np.std(y, ddof=1))

    i_nan = np.isnan(x0)
    x0[i_nan] = 0.5 * (PLB[i_nan] + PUB[i_nan])

    return {"LB": LB, "UB": UB, "PLB": PLB, "PUB": PUB, "x0": x0}
