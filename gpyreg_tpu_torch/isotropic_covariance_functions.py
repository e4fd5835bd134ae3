"""Isotropic covariance functions: a single shared lengthscale (2
hyperparameters regardless of D), computed through the ``*_iso`` kernel
kinds of ``ops/kernels.py``.

Port of ``gpyreg_tpu/isotropic_covariance_functions.py``: ``_kind``, the
hyperparameter counts and info, and ``compute``.  Left out until the fit
slice: the recommended bounds (:30-32, :75-108).
"""

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


class MaternIsotropic(AbstractIsotropicKernel, Matern):
    """Isotropic Matern kernel of degree 1, 3 or 5."""

    def __init__(self, degree: int):
        Matern.__init__(self, degree)
        self._kind = f"m{degree}_iso"


class SquaredExponentialIsotropic(AbstractIsotropicKernel, SquaredExponential):
    """Isotropic squared exponential kernel."""

    _kind = "se_iso"
