"""The result line's keys, and the runs that must print none."""

import json
import shutil
import subprocess
import sys

from conftest import ROOT, run_tiny, tiny_cell

from benchmark import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line_has_the_contract_keys():
    cell = tiny_cell("infer.default.b16")
    line = run_tiny(cell)
    assert list(line) == KEYS + ["checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert line["correct"] is True
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_traced_line_has_busy_window_and_breakdown():
    cell = tiny_cell("infer.fast.b16")
    line = run_tiny(cell, trace=True)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no card: the device readers find nothing and stay silent
    names = set(line["metrics"])
    assert "device_idle.infer" not in names
    assert names <= {m["name"] for m in cell.per_layer}


def test_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "infer.default.b16", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == harness.EXIT_NO_CARD
    assert out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "infer.default.b16", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_workload_is_refused():
    assert harness.main(["--workload", "nope", "--seed", "1", "--seconds",
                         "1"], 0.0) == harness.EXIT_BAD_CELL
