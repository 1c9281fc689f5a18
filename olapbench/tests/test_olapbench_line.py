"""The result line a run prints, and what a run refuses."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from olapbench import spec
from olapbench.tests.cells import line_of

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_untraced_line_has_the_end_to_end_metrics(name):
    line = line_of(name)
    assert list(line) == KEYS + ["checks"]  # the numbers compared come last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    cell = spec.cell(name)
    # no peak on the CPU: the memory metric is left out there, never read as 0
    want = {m["name"] for m in cell.end_to_end} - {"device_gib_peak"}
    assert set(line["metrics"]) == want
    for m in cell.end_to_end:
        if m["name"] in line["metrics"]:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
    assert line["device"]["platform"] == "cpu"  # never "gpu" off the card
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_traced_line_has_busy_window_and_breakdown(name):
    line = line_of(name, trace=True)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    allowed = {m["name"] for m in spec.cell(name).per_layer}
    assert set(line["metrics"]) <= allowed and line["metrics"]
    assert json.loads(json.dumps(line)) == line


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", "olapbench.run", "--workload", CELLS[0],
                           "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    res = _run(ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA device" in res.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "olapbench", tmp_path / "olapbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_out"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
    assert "No module named 'dpu_olap_tpu_torch'" in res.stderr
