"""A replay of the JAX package's chain key tree as a random stream of the
port (``gpyreg_tpu_torch.inference.device_slice``), for the tests that
hold the port's chains to the JAX package's proposal by proposal.

The splits are those of ``gpyreg_tpu/inference/device_slice.py``: per
sweep ``key, k_perm = split(key)`` and the scan order (``_sweep``); per
coordinate ``key, k_dim = split(key)``, then ``k_level, k_pos, k_prop =
split(k_dim, 3)`` and per proposal ``k_prop, ku = split(k_prop)``
(``_dim_body_factory``); per random-direction move ``key, k_dir, k_level,
k_pos, k_prop = split(key, 5)`` (``_rd_sweep``); per chain
``split(key, B)`` (``sample_chains``).  The gradient samplers' splits
are those of ``gpyreg_tpu/inference/mala.py`` (per step ``key, k_prop,
k_acc = split(key, 3)``), ``hmc.py`` (per iteration ``key, k_mom, k_jit,
k_acc = split(key, 4)``) and ``ensemble_slice.py`` (``key, k_fill =
split(key)`` before the chain; per iteration ``key, kA, kB = split(key,
3)``; per half ``split(k, n + 1)``, the pick key first, and the walker
moves of a slice step).  ``patch_streams`` makes the
port's ``make_stream(seed)`` return ``replay(seed)``, the stream of
``jax.random.key(seed)``, which is the key the JAX package builds from
the same integer.

``patch_probes`` does the same for the matrix-free tier's probes: the
port's ``ops.iterative.make_probes(seed, shape, ...)`` returns
``jax.random.rademacher(jax.random.key(seed), shape)``, the block
``gpyreg_tpu/ops/iterative.py:473`` draws from the key of that integer.
"""

import jax
import jax.numpy as jnp
import numpy as np

import torch

import gpyreg_tpu  # noqa: F401  (float64 on: the chains' uniforms are float64)
from gpyreg_tpu_torch.inference import device_slice as TDS
from gpyreg_tpu_torch.ops import iterative as TIT

_TINY = float(np.finfo(np.float64).tiny)


class _Move:
    def __init__(self, k_level, k_pos, k_prop):
        self.k_level, self.k_pos, self.k_prop = k_level, k_pos, k_prop

    def level(self):
        return float(jax.random.uniform(self.k_level, minval=_TINY))

    def position(self):
        return float(jax.random.uniform(self.k_pos))

    def proposal(self):
        self.k_prop, ku = jax.random.split(self.k_prop)
        return float(jax.random.uniform(ku))


class JaxReplay:
    def __init__(self, key):
        self.key = key

    def permutation(self, D):
        self.key, k_perm = jax.random.split(self.key)
        return np.asarray(jax.random.permutation(k_perm, D))

    def coordinate(self):
        self.key, k_dim = jax.random.split(self.key)
        return _Move(*jax.random.split(k_dim, 3))

    def direction(self, D):
        self.key, k_dir, k_level, k_pos, k_prop = jax.random.split(self.key, 5)
        u = np.asarray(jax.random.normal(k_dir, (D,), dtype=jnp.float64))
        return u, _Move(k_level, k_pos, k_prop)

    def split(self, B):
        return [JaxReplay(k) for k in jax.random.split(self.key, B)]

    def langevin(self, D):
        self.key, k_prop, k_acc = jax.random.split(self.key, 3)
        xi = np.asarray(jax.random.normal(k_prop, (D,), dtype=jnp.float64))
        return xi, float(jax.random.uniform(k_acc, minval=_TINY))

    def hamiltonian(self, D):
        self.key, k_mom, k_jit, k_acc = jax.random.split(self.key, 4)
        jit = float(jax.random.uniform(k_jit, minval=0.9, maxval=1.1))
        p0 = np.asarray(jax.random.normal(k_mom, (D,), dtype=jnp.float64))
        return p0, jit, float(jax.random.uniform(k_acc, minval=_TINY))

    def fill(self, need, D):
        self.key, k_fill = jax.random.split(self.key)
        return np.asarray(jax.random.normal(k_fill, (need, D)))

    def ensemble_iteration(self):
        self.key, kA, kB = jax.random.split(self.key, 3)
        return _Half(kA), _Half(kB)


class _Half:
    def __init__(self, key):
        self.key = key

    def half_move(self, n, H):
        keys = jax.random.split(self.key, n + 1)
        k_pick = keys[0]
        i1 = np.asarray(jax.random.randint(k_pick, (n,), 0, H))
        off = np.asarray(
            jax.random.randint(jax.random.fold_in(k_pick, 1), (n,), 1, H))
        return i1, off, [_Move(*jax.random.split(k, 3)) for k in keys[1:]]


def replay(seed):
    return JaxReplay(jax.random.key(int(seed)))


def patch_streams(monkeypatch):
    monkeypatch.setattr(TDS, "make_stream", replay)


def jax_probes(seed, shape, dtype, device):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    z = jax.random.rademacher(jax.random.key(int(seed)), tuple(shape), dtype=jdt)
    return torch.as_tensor(np.array(z)).to(dtype=dtype, device=device)


def patch_probes(monkeypatch):
    monkeypatch.setattr(TIT, "make_probes", jax_probes)
