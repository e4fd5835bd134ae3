"""Hyperparameter inference for the PyTorch port: the design and
multistart-MAP phase of ``GP.fit`` (``fit_phases``, ``map_optimize``) and
its hyperposterior sampling phase (``sampling``, over the slice chain of
``device_slice``, the gradient chains of ``mala`` and ``hmc`` and the
ensemble chain of ``ensemble_slice``).

The JAX package's matrix-free fit (``cg_fit``) is not ported yet.
"""
