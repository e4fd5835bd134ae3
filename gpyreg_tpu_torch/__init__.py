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
samples, ``GP.predict``, ``save``/``load``), the NLML with its gradient,
batched over hyperparameter vectors, with and without the hyperprior
(``core.nlml.get_fns``, ``GP.log_likelihood``, ``GP.log_posterior``),
``GP.fit``: the design, the multistart MAP and the sampled
hyperposterior (slicesample, covsample, chains, the slicelite warm
refit, the host ``SliceSampler``, MALA, HMC and ensemble slice
sampling), and the rest of serving: the rank-1 ``update``,
``predict_full``, ``quad``, ``random_function``, ``predict_quantile``,
``fmin``, ``sample`` and ``plot``; output warping
(``outwarp_functions``, ``GP(..., outwarp=...)``), the matrix-free
tier (``ops.iterative``, ``GP.fit(options={"method": "cg"})`` and
``"auto"``, whose CG panels the kernel tile builds) and the multi-device
tier (``parallel``: ``GP(..., mesh=...)`` shards predict, quad and fit
over a mesh of devices, and ``parallel.dist_exact`` builds, factors and
serves the exact GP row-sharded over it).
"""

from . import covariance_functions
from . import f_min_fill
from . import isotropic_covariance_functions
from . import mean_functions
from . import noise_functions
from . import outwarp_functions
from . import parallel
from . import slice_sample
from .gp import GP, Posterior

__version__ = "0.1.0"

__all__ = [
    "GP",
    "Posterior",
    "covariance_functions",
    "isotropic_covariance_functions",
    "mean_functions",
    "noise_functions",
    "outwarp_functions",
    "f_min_fill",
    "slice_sample",
]
