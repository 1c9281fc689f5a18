"""The port's benchmark harness (dpu_olap_tpu_torch.bench.harness) against
the JAX package's (dpu_olap_tpu/bench/harness.py): the same JSON keys, the
median of the timed iterations, the spread, and the synchronisation of
every tensor among a result."""

import dataclasses
import json

import pytest
import torch

from dpu_olap_tpu.bench import harness as jax_harness
from dpu_olap_tpu_torch.bench import harness


def test_to_json_keys_match_jax():
    fields = dict(name="x", real_ms=1.5, items_per_s=2.0, bytes_per_s=8.0, iterations=5,
                  counters={"phase_ms": 0.25})
    got = json.loads(harness.BenchResult(**fields).to_json())
    want = json.loads(jax_harness.BenchResult(**fields).to_json())
    assert got == want
    assert list(got) == list(want)


@pytest.fixture
def scripted_clock(monkeypatch):
    """time.perf_counter returning 0 at each call's start and the given
    seconds at its end, in turn."""
    def install(durations):
        ticks = []
        for d in durations:
            ticks += [0.0, d]
        it = iter(ticks)
        monkeypatch.setattr(harness.time, "perf_counter", lambda: next(it))
    return install


def test_time_fn_is_the_median_of_the_timed_iterations(scripted_clock):
    calls = []
    scripted_clock([0.5, 0.1, 0.3, 0.2, 0.4])
    sec = harness.time_fn(lambda: calls.append(1), warmup=2, iters=5)
    assert sec == 0.3 and len(calls) == 7  # warm-up calls are not timed


def test_time_samples_sorted_and_spread(scripted_clock):
    scripted_clock([0.4, 0.2, 0.3])
    s = harness.time_samples(lambda: None, warmup=0, iters=3)
    assert s == [0.2, 0.3, 0.4]
    assert harness.median(s) == 0.3
    assert harness.spread_pct(s) == pytest.approx(100.0 * 0.2 / 0.3)
    assert harness.spread_pct([0.0, 0.0]) == 0.0


def test_run_benchmark_rates(scripted_clock):
    scripted_clock([0.2, 0.1, 0.3])
    r = harness.run_benchmark("op", lambda: None, items=1000, bytes_per_item=8, warmup=0,
                              iters=3, counters={"k": 1.0})
    assert (r.real_ms, r.items_per_s, r.bytes_per_s, r.iterations) == pytest.approx(
        (200.0, 5000.0, 40000.0, 3))
    assert json.loads(r.to_json())["k"] == 1.0


def test_bench_result_is_the_row_of_its_samples():
    r = harness.bench_result("op", [0.3, 0.1, 0.2], items=600, bytes_per_item=2,
                             counters={"spread_pct": 100.0})
    assert (r.real_ms, r.items_per_s, r.bytes_per_s, r.iterations) == pytest.approx(
        (200.0, 3000.0, 6000.0, 3))
    assert r.row() == json.loads(r.to_json())
    assert list(r.row()) == ["name", "real_ms", "items_per_s", "bytes_per_s", "iterations",
                             "spread_pct"]


@dataclasses.dataclass
class _Out:
    a: torch.Tensor
    rest: tuple


def test_sync_walks_every_tensor_of_a_result(monkeypatch):
    seen = []
    t = torch.zeros(2)
    out = {"x": [t, (t, _Out(t, (t, 3)))], "n": 1}
    assert len(list(harness._tensors(out))) == 4
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: seen.append(dev))
    harness.sync(out)  # CPU tensors: nothing to wait for
    assert seen == []


def test_sync_waits_on_the_tensors_own_device(monkeypatch):
    seen = []

    class FakeCuda:
        device = torch.device("cuda", 3)

    monkeypatch.setattr(harness, "_tensors", lambda out: iter([FakeCuda(), FakeCuda()]))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: seen.append(dev))
    harness.sync(None)
    assert seen == [torch.device("cuda", 3)]  # that device, once, not the default one


def test_device_set_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.device_set("cuda")
    assert harness.device_set("cpu").device == torch.device("cpu")
    assert harness.card_missing("cuda", "prog") and not harness.card_missing("cpu", "prog")
