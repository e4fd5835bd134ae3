"""BENCHMARK.json against the limits of its format (names, units, keys,
bounds), and every file of a cell found by its names."""

import json
import os
import re

import pytest

from portbench import harness
from portbench.tests.tiny import CELLS, ROOT, small
from portbench.tests.tiny import manifest as read_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return read_manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_entries(manifest):
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/")
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        # Every per-layer entry names the cells that report it.
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["workloads"] and set(m["workloads"]) <= set(cells)
        moved = next(e for e in manifest["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert len(set(cells)) == len(cells)
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_few_cells_ask_for_four_chips(manifest):
    """At most a quarter of the cells, rounded down, or one, on 4 chips."""
    cells = manifest["workloads"]
    four = [w["name"] for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4), four


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.Cell(ROOT, name)
    kind = cell.kind()
    assert hasattr(kind, "Runner")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
        assert m["moves"] in e2e
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    entry = next(c for c in read_manifest()["configs"]
                 if c["name"] == cell.entry["config"])
    assert cell.cfg["reduced"] == entry["reduced"]
    assert {"sizes", "control"} <= set(small(cell.entry["config"]))


def test_config_files_match_manifest(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(set(files)) == len(files)
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
