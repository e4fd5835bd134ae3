"""Alias module for reference-compatible imports.

Port of ``gpyreg_tpu/gaussian_process.py``: the reference exposes its GP
class from ``gpyreg.gaussian_process`` (reference gpyreg/__init__.py:8),
so ``from gpyreg_tpu_torch.gaussian_process import GP`` works as the
import path of either package does.
"""

from .gp import GP, Posterior

__all__ = ["GP", "Posterior"]
