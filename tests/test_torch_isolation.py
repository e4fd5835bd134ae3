"""The port package stands without JAX: importing every module of
gpyreg_tpu_torch in a fresh interpreter leaves ``jax`` out of
``sys.modules``, and no file of the package names the ``jax`` module."""

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


def test_import_leaves_jax_out():
    modules = sorted(
        "gpyreg_tpu_torch."
        + os.path.relpath(p, PKG)[: -len(".py")].replace(os.sep, ".")
        for p in _package_files()
        if p.endswith(".py") and not p.endswith("__init__.py")
    )
    code = (
        "import importlib, sys\n"
        "import gpyreg_tpu_torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 12


def test_no_file_names_jax():
    pattern = re.compile(r"\bjax\b")
    files = list(_package_files())
    assert files
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pattern.search(line), f"{path}:{i}: {line.strip()}"
