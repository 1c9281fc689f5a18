"""The port's metrics and config (dpu_olap_tpu_torch.metrics, .config), twin
of tests/test_metrics_config.py:16-47: Counters against the JAX package's
JSON, the env overrides with the flags ENABLE_PERF and ENABLE_TRACE,
stream_rounds' bound on dispatched rounds, and the trace scope (a torch.profiler region,
and with a directory a Chrome trace). Also the ENABLE_TRACE hook of the v1
filter on the CPU: a line a tile of 4096 values, whose counts add up to the
filter's. Every comparison is exact."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dpu_olap_tpu.config import Flags as JaxFlags
from dpu_olap_tpu.metrics import Counters as JaxCounters
from dpu_olap_tpu_torch import config
from dpu_olap_tpu_torch.config import FLAGS
from dpu_olap_tpu_torch.metrics import Counters, trace
from dpu_olap_tpu_torch.ops import filter as filt
from dpu_olap_tpu_torch.ops import filter_cuda
from dpu_olap_tpu_torch.parallel.streaming import stream_rounds
from dpu_olap_tpu_torch.timer import Timers, timed

REPO = Path(__file__).resolve().parents[1]


def test_counters_emit_roundtrip(capsys):
    c = Counters("bm_test").set("x", 1.5)
    c.items_processed(1000, 0.5)
    c.emit()
    out = json.loads(capsys.readouterr().out)
    assert out["name"] == "bm_test" and out["items_per_s"] == 2000.0
    j = JaxCounters("bm_test").set("x", 1.5)
    j.items_processed(1000, 0.5)
    assert c.to_json() == j.to_json()


def test_counters_fold_timers():
    t = Timers()
    for rank in range(2):
        with timed(t, "phase", rank):
            time.sleep(0.001)
    c = Counters("bm").timers(t, ["phase"]).rate("rows_per_s", 10, 2.0)
    j = JaxCounters("bm").timers(t, ["phase"]).rate("rows_per_s", 10, 2.0)
    assert set(c.values) == set(j.values) == {"phase_ms", "rows_per_s"}
    assert c.values == j.values
    assert c.values["phase_ms"] == t.sum_ms("phase") / 2  # normalized by rank count


def test_config_env_overrides(monkeypatch):
    monkeypatch.setenv("NR_DEVICES", "3")
    assert config.nr_devices() == 3
    monkeypatch.delenv("NR_DEVICES")
    monkeypatch.setenv("NR_DPUS", "5")  # the reference's spelling
    assert config.nr_devices() == 5
    monkeypatch.setenv("SF", "7")
    assert config.scale_factor() == 7
    monkeypatch.setenv("MAX_THREADS", "3")
    assert config.max_threads() == 3


def _flags_in_subprocess(env: dict) -> dict:
    code = (
        "import dataclasses, json\n"
        "from dpu_olap_tpu_torch.config import FLAGS\n"
        "print(json.dumps(dataclasses.asdict(FLAGS)))\n"
    )
    base = {k: v for k, v in os.environ.items()
            if k not in ("ENABLE_PERF", "ENABLE_LOG", "ENABLE_TRACE")}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**base, **env})
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


def test_flags_defaults_and_env_overrides():
    d = _flags_in_subprocess({})
    assert (d["enable_perf"], d["enable_log"], d["enable_trace"]) == (True, False, False)
    assert d["stream_round_rows"] == 64 << 20
    o = _flags_in_subprocess({"ENABLE_PERF": "0", "ENABLE_LOG": "1", "ENABLE_TRACE": "1"})
    assert (o["enable_perf"], o["enable_log"], o["enable_trace"]) == (False, True, True)
    # the JAX package's flags of the same names, and no flag it lacks
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxFlags)}
    for name, value in d.items():
        assert name in jax_fields and jax_fields[name] == value, name


def test_stream_rounds_reads_max_inflight():
    live = peak = 0
    lock = threading.Lock()

    def dispatch(r, staged):
        nonlocal live, peak
        with lock:
            live += 1
            peak = max(peak, live)
        return staged

    def collect(r, h):
        nonlocal live
        time.sleep(0.02)
        with lock:
            live -= 1
        return h

    # the default bound is the JAX package's FLAGS.stream_max_inflight, 2
    for bound in (None, 1, 3):
        live = peak = 0
        kw = {} if bound is None else {"max_inflight": bound}
        assert stream_rounds(8, lambda r: r, dispatch, collect, **kw) == list(range(8))
        assert peak <= (bound or 2), (bound, peak)
        assert peak == (bound or 2), (bound, peak)


def test_trace_annotation_runs():
    with trace("phase-x") as path:
        _ = torch.arange(8).sum()
    assert path is None


def test_trace_writes_chrome_trace(tmp_path):
    with trace("phase-y", trace_dir=str(tmp_path)) as path:
        _ = (torch.arange(1 << 12) * 3).sum()
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert Path(path).parent == tmp_path
    assert any(e.get("name") == "phase-y" for e in events)


def test_trace_without_enable_perf_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(FLAGS, "enable_perf", False)
    with trace("phase-z", trace_dir=str(tmp_path)) as path:
        _ = torch.arange(8).sum()
    assert path is None and list(tmp_path.iterdir()) == []


def _parse(lines):
    out = []
    for line in lines:
        w = line.split()
        assert w[:2] == ["filter", "block"] and w[3] == "offset" and w[5] == "kept", line
        out.append((int(w[2]), int(w[4]), int(w[6])))
    return out


@pytest.mark.parametrize("n", [1, 4096, 3 * 4096 + 5])
@pytest.mark.parametrize("with_indices", [False, True])
def test_enable_trace_prints_a_line_a_tile(capsys, monkeypatch, n, with_indices):
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32))
    monkeypatch.setattr(FLAGS, "enable_trace", True)
    before = filter_cuda.LAUNCHES
    if with_indices:
        *_, count = filt.filter_with_indices(v)
    else:
        _, count = filt.filter_compact(v)
    assert filter_cuda.LAUNCHES == before  # the CPU path is the plain version
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("filter block")]
    rows = _parse(lines)
    assert [t for t, _, _ in rows] == list(range(-(-n // filter_cuda.TILE)))
    assert sum(k for _, _, k in rows) == int(count)
    assert [o for _, o, _ in rows] == list(np.cumsum([0] + [k for _, _, k in rows])[:-1])
    assert lines == filter_cuda.trace_lines(v)
    monkeypatch.setattr(FLAGS, "enable_trace", False)
    filt.filter_compact(v)
    assert "filter block" not in capsys.readouterr().out


def test_staging_needs_a_card(capsys):
    from dpu_olap_tpu_torch.bench import staging

    assert staging.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
