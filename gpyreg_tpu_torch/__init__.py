"""gpyreg_tpu_torch: the PyTorch and CUDA port of gpyreg_tpu.

Exact Gaussian-process regression behind the ``gpyreg_tpu`` API
(hyperparameter layout cov | noise | mean | outwarp, the ``GP`` object
and its ``Posterior``), running on PyTorch tensors on the CUDA card
unless the caller passes ``device="cpu"``.  The two Pallas kernels of
the JAX package, the fused distance + kernel tile and its one-pass
gradient, are hand-written CUDA kernels for Hopper
(``csrc/kernel_tile.cu``, ``csrc/kernel_vjp.cu``), built at first use.

This package imports ``torch`` and never JAX.  It covers serving
(``GP.update`` with a full posterior rebuild over S hyperparameter
samples, ``GP.predict``, ``save``/``load``) and the NLML with its
gradient, batched over hyperparameter vectors, with and without the
hyperprior (``core.nlml.get_fns``, ``GP.log_likelihood``,
``GP.log_posterior``).  ``ROADMAP.md`` lists the modules still to come.
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
