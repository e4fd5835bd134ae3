"""Hyperparameter inference for the PyTorch port: the design and
multistart-MAP phase of ``GP.fit`` (``fit_phases``, ``map_optimize``) and
its hyperposterior sampling phase (``sampling``, over the slice chain of
``device_slice``).

The JAX package's gradient samplers (``ensemble_slice``, ``mala``,
``hmc``) and its matrix-free fit (``cg_fit``) are not ported yet.
"""
