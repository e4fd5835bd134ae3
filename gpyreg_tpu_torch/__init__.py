"""gpyreg_tpu_torch: the PyTorch and CUDA port of gpyreg_tpu.

Exact Gaussian-process regression behind the ``gpyreg_tpu`` API
(hyperparameter layout cov | noise | mean | outwarp, the ``GP`` object
and its ``Posterior``), running on PyTorch tensors on a chosen
``device``.  The fused distance + kernel tile of the JAX package's
Pallas code is a hand-written CUDA kernel for Hopper
(``csrc/kernel_tile.cu``), built at first use.

This package imports ``torch`` and never JAX.  It covers the serving
slice: ``GP.update`` (full posterior rebuild over S hyperparameter
samples), ``GP.predict``, ``save``/``load``.  ``ROADMAP.md`` lists the
modules still to come.
"""

from . import covariance_functions
from . import isotropic_covariance_functions
from . import mean_functions
from . import noise_functions
from .gp import GP, Posterior

__version__ = "0.1.0"

__all__ = [
    "GP",
    "Posterior",
    "covariance_functions",
    "isotropic_covariance_functions",
    "mean_functions",
    "noise_functions",
]
