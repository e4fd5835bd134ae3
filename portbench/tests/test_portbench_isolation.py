"""The benchmark loads no JAX and no ``gpyreg_tpu``; its reference loads
nothing of the port; ``run.py`` without a card exits non-zero."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gpyreg_tpu"}

GRAPH = """
import importlib, json, os, pkgutil, sys
sys.path.insert(0, {root!r})
import runpy
runpy.run_path({run!r}, run_name="portbench_run")
import portbench.harness, portbench.calibrate, portbench.reference.gp
import gpyreg_tpu_torch
base = os.path.join({root!r}, "portbench")
for sub in ("kinds", "work"):
    for m in pkgutil.iter_modules([os.path.join(base, sub)]):
        importlib.import_module(f"portbench.{{sub}}.{{m.name}}")
from portbench.harness import Cell
for w in json.load(open(os.path.join({root!r}, "BENCHMARK.json")))["workloads"]:
    cell = Cell({root!r}, w["name"])
    cell.kind()
    for m in cell.per_layer:
        cell.reader(m["name"])
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_module_graph_loads_no_jax():
    code = GRAPH.format(root=ROOT, run=os.path.join(ROOT, "portbench", "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gpyreg_tpu_torch" in tops and "portbench" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    base = os.path.join(ROOT, "portbench", "reference")
    files = [os.path.join(base, f) for f in os.listdir(base) if f.endswith(".py")]
    assert files
    for path in files:
        tops = set(_imports(path))
        assert not tops & (FORBIDDEN | {"gpyreg_tpu_torch"}), (path, tops)
        # Nothing of the harness either: the reference is plain PyTorch.
        assert tops <= {"contextlib", "math", "torch", "numpy"}, (path, tops)


def test_no_harness_file_imports_jax():
    base = os.path.join(ROOT, "portbench")
    for dirpath, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py"):
                tops = set(_imports(os.path.join(dirpath, n)))
                assert not tops & FORBIDDEN, (n, tops)


def test_run_without_a_card_exits_nonzero():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "d8.nlml_grad", "--seed",
         "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_run_alone_without_the_port_exits_nonzero(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "d8.nlml_grad", "--seed",
         "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["d8.nlml_grad", "config5.posterior"])
def test_cell_runs_correct_on_the_card(name, cuda):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
