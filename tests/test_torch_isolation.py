"""The port package stands without JAX: importing every module of
gpyreg_tpu_torch (the ``inference`` subpackage, ``outwarp_functions``
and ``ops.iterative`` included) in a fresh
interpreter leaves ``jax``, ``optax`` and ``gpyreg_tpu`` out of
``sys.modules``, and no file of the package names the ``jax`` module.
Nor does the import pull in ``matplotlib``, which only ``GP.plot``
imports."""

import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gpyreg_tpu_torch")


def _package_files():
    for dirpath, _, files in os.walk(PKG):
        if os.path.basename(dirpath) in ("build", "__pycache__"):
            continue
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, name)


def _modules():
    return sorted(
        "gpyreg_tpu_torch."
        + os.path.relpath(p, PKG)[: -len(".py")].replace(os.sep, ".")
        for p in _package_files()
        if p.endswith(".py") and not p.endswith("__init__.py")
    )


def test_import_leaves_jax_out():
    modules = _modules()
    code = (
        "import importlib, sys\n"
        "import gpyreg_tpu_torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'gpyreg_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 14
    for name in ("inference.map_optimize", "inference.fit_phases",
                 "inference.device_slice", "inference.sampling", "slice_sample",
                 "inference.mala", "inference.hmc", "inference.ensemble_slice",
                 "core.rank1", "formatting", "gaussian_process",
                 "outwarp_functions", "ops.iterative", "inference.cg_fit",
                 "parallel.mesh", "parallel.dist_exact"):
        assert "gpyreg_tpu_torch." + name in modules


def test_import_leaves_matplotlib_out():
    code = (
        "import importlib, sys\n"
        "import gpyreg_tpu_torch\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "assert hasattr(gpyreg_tpu_torch.GP, 'plot')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_inference_subpackage_alone_leaves_jax_out():
    """``import gpyreg_tpu_torch.inference`` and its modules, with
    nothing else asked for, pull in torch, numpy and scipy only."""
    code = (
        "import sys\n"
        "import gpyreg_tpu_torch.inference\n"
        "from gpyreg_tpu_torch.inference import (cg_fit, device_slice,\n"
        "                                        ensemble_slice, fit_phases,\n"
        "                                        hmc, mala, map_optimize,\n"
        "                                        sampling)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'gpyreg_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules and 'scipy' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_a_map_fit_does_not_import_sympy():
    """The first L-BFGS evaluation of a process must not pull in torch's
    symbolic-shape machinery (``torch.autograd.grad`` imports it, and with
    it sympy, when it is given ``grad_outputs``): that import takes
    seconds, as long as a whole fit at N = 4096 on the card."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import gpyreg_tpu_torch as gt\n"
        "assert 'sympy' not in sys.modules\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(32, 2))\n"
        "y = np.sin(X.sum(axis=1, keepdims=True))\n"
        "g = gt.GP(2, gt.covariance_functions.SquaredExponential(),\n"
        "          gt.mean_functions.ConstantMean(),\n"
        "          gt.noise_functions.GaussianNoise(constant_add=True),\n"
        "          device='cpu')\n"
        "_, res, _ = g.fit(X, y, options={'n_samples': 0, 'init_N': 4,\n"
        "                                 'opts_N': 1})\n"
        "assert res.nit > 0\n"
        "assert 'sympy' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_file_names_jax():
    pattern = re.compile(r"\bjax\b")
    files = list(_package_files())
    assert files
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pattern.search(line), f"{path}:{i}: {line.strip()}"
