"""Cells are added as data: in a copy of the benchmark's files,
``added_cells/`` adds a one-card cell of an existing kind and a four-card
cell of a new kind as new files and new ``BENCHMARK.json`` entries
alone.  The harness runs the first as it runs the files' cells, the
copy's own tests pass against both, and no byte of a file that was there
changes."""

import json
import os
import shutil
import subprocess
import sys

import gpyreg_tpu_torch
from portbench import harness
from portbench.tests import tiny

ADDED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "added_cells")


def add_cells(root):
    """Add ``added_cells/`` to the benchmark under ``root``: each of its
    files at the same place under ``portbench/`` (none may be there yet),
    and the entries of its ``manifest.json`` at the ends of the lists of
    ``BENCHMARK.json``; under ``like``, a new cell joins the ``workloads``
    of every metric that lists the cell named beside it."""
    for dirpath, _, names in os.walk(ADDED):
        for n in names:
            src = os.path.join(dirpath, n)
            rel = os.path.relpath(src, ADDED)
            if rel == "manifest.json" or "__pycache__" in rel:
                continue
            dst = os.path.join(root, "portbench", rel)
            assert not os.path.exists(dst), dst
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(src, dst)
    with open(os.path.join(ADDED, "manifest.json")) as f:
        added = json.load(f)
    manifest = tiny.manifest(root)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        manifest[key] += added[key]
    for new, like in added["like"].items():
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(new)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _copy(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``portbench/`` with the cells
    added, and the bytes of every file of the copy before they were."""
    shutil.copytree(os.path.join(tiny.ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    add_cells(str(tmp_path))
    return before


def _unchanged(before):
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p


def test_new_cell_from_files_alone(tmp_path):
    before = _copy(tmp_path)
    for trace in (0, 1):
        result, checks, _ = harness.run_cell(
            str(tmp_path), "throwaway.small_predict", 11, 0.1, trace, "cpu", 0.0)
        assert result["correct"], checks
    assert "predict_pts_per_s" in harness.run_cell(
        str(tmp_path), "throwaway.small_predict", 12, 0.1, 0, "cpu",
        0.0)[0]["metrics"]
    _unchanged(before)


def test_added_cells_pass_the_copys_own_tests(tmp_path):
    before = _copy(tmp_path)
    old = tiny.manifest()
    new = tiny.manifest(str(tmp_path))
    # The manifest only grows: every entry that was there is there as it was.
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        kept = {e["name"]: e for e in new[key]}
        for e in old[key]:
            got = dict(kept[e["name"]])
            if "workloads" in e:
                assert got["workloads"][:len(e["workloads"])] == e["workloads"]
                got["workloads"] = e["workloads"]
            assert got == e
    # The copy's own tests, this file's left out, on the copy's files and
    # the port this process imports.
    port = os.path.dirname(os.path.dirname(os.path.abspath(
        gpyreg_tpu_torch.__file__)))
    path = [port] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(path)}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "portbench/tests", "-v",
         "-p", "no:cacheprovider", "-p", "no:randomly",
         "--ignore=portbench/tests/test_portbench_data_driven.py"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=600)
    assert out.returncode == 0, out.stdout[-6000:] + out.stderr[-2000:]
    for case in (
            "test_portbench_manifest.py::test_cell_files_found_by_name"
            "[throwaway_dist.dist_fit] PASSED",
            "test_portbench_manifest.py::test_few_cells_ask_for_four_chips PASSED",
            "test_portbench_traffic.py::test_step_runs_and_is_correct"
            "[1-throwaway_dist.dist_fit] PASSED",
            "test_portbench_traffic.py::test_control_fails_a_limit"
            "[throwaway.small_predict] PASSED",
            "test_portbench_traffic.py::test_control_fails_a_limit"
            "[throwaway_dist.dist_fit] PASSED",
            "test_portbench_traffic.py::test_broken_timed_path_is_not_correct"
            "[throwaway.small_predict-half_samples] PASSED",
            "test_portbench_kind_throwaway_dist_fit.py::"
            "test_broken_timed_path_is_not_correct"
            "[throwaway_dist.dist_fit-no_exchange] PASSED",
            "test_portbench_isolation.py::test_module_graph_loads_no_jax PASSED"):
        assert case in out.stdout, case
    _unchanged(before)
