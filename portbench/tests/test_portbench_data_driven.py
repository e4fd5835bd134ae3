"""A cell is added as data: a throwaway configuration file, a manifest
entry and a limits file, in a copy of the benchmark's files, run by the
harness without an edit to any file that was there."""

import json
import os
import shutil

from portbench import harness
from portbench.tests import tiny


def test_new_cell_from_files_alone(tmp_path):
    shutil.copytree(os.path.join(tiny.ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cfg = {"name": "throwaway", "source": "https://github.com/acerbilab/gpyreg",
           "model": "ard_se_const_gauss", "dtype": "float32", "N": 40, "D": 2,
           "S": 2, "noise_sd": 0.1, "reduced": [],
           "serve_hyp": {"log_ell": 0.0, "log_sf": 0.0, "log_sn": -2.3,
                         "mean": 0.0, "jitter_sd": 0.05}}
    (tmp_path / "portbench/configs/throwaway.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/traffic/small_predict.json").write_text(json.dumps(
        {"kind": "predict", "points_per_request": 100, "judged_points": 50,
         "trace_steps": 1}))
    (tmp_path / "portbench/limits/throwaway.small_predict.json").write_text(
        json.dumps({"mean_gap": {"limit": 1e-3}, "var_gap": {"limit": 1e-3}}))
    manifest["configs"].append({"name": "throwaway", "source": cfg["source"],
                                "file": "portbench/configs/throwaway.json",
                                "reduced": [], "why": "a test's cell"})
    manifest["workloads"].append({"name": "throwaway.small_predict",
                                  "config": "throwaway",
                                  "traffic": "small_predict", "chips": 1,
                                  "why": "a test's cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "config5.predict" in m.get("workloads", []):
            m["workloads"].append("throwaway.small_predict")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    for trace in (0, 1):
        result, checks, _ = harness.run_cell(
            str(tmp_path), "throwaway.small_predict", 11, 0.1, trace, "cpu", 0.0)
        assert result["correct"], checks
    assert "predict_pts_per_s" in harness.run_cell(
        str(tmp_path), "throwaway.small_predict", 12, 0.1, 0, "cpu",
        0.0)[0]["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data, p
