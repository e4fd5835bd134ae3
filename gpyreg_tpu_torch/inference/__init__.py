"""Hyperparameter inference for the PyTorch port: the design and
multistart-MAP phase of ``GP.fit`` (``fit_phases``, ``map_optimize``).

The JAX package's samplers (``sampling``, ``device_slice``,
``ensemble_slice``, ``mala``, ``hmc``) and its matrix-free fit
(``cg_fit``) are not ported yet.
"""
