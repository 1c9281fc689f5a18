"""Timing harness for the port's benchmarks (counterpart of
``dpu_olap_tpu/bench/harness.py``).

Reference: Google Benchmark registrations in host/*/\\*_benchmark.cc with
bytes/items processed counters and per-phase timers normalized by rank count
(join_benchmark.cc:48-60). Here: warmup + timed iterations on the host
clock; each iteration ends by synchronising the device of every tensor among
``fn()``'s outputs (the dpu_sync analog; the JAX version's
``block_until_ready`` on each leaf).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Callable, Dict, List

import torch


@dataclasses.dataclass
class BenchResult:
    name: str
    real_ms: float  # per-iteration wall ms
    items_per_s: float
    bytes_per_s: float
    iterations: int
    counters: Dict[str, float]

    def row(self) -> dict:
        """The row as the JSON object that ``to_json`` writes."""
        return {
            "name": self.name,
            "real_ms": self.real_ms,
            "items_per_s": self.items_per_s,
            "bytes_per_s": self.bytes_per_s,
            "iterations": self.iterations,
            **self.counters,
        }

    def to_json(self) -> str:
        return json.dumps(self.row())


def _tensors(out):
    """The tensors among a result: nested tuples, lists, dicts and
    dataclasses are walked."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _tensors(x)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))


def sync(out) -> None:
    """Wait for the device work behind every CUDA tensor in ``out``, on that
    tensor's own device."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_samples(fn: Callable, warmup: int = 2, iters: int = 5) -> List[float]:
    """Wall seconds of ``iters`` calls of fn() after ``warmup`` calls, each
    call's outputs synchronised inside its time, sorted."""
    for _ in range(warmup):
        sync(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn())
        times.append(time.perf_counter() - t0)
    return sorted(times)


def median(samples: List[float]) -> float:
    s = sorted(samples)
    return s[len(s) // 2]


def spread_pct(samples: List[float]) -> float:
    """(max - min) / median of the samples, in percent (bench.py's
    ``aggregate_samples``)."""
    m = median(samples)
    return 100.0 * (max(samples) - min(samples)) / abs(m) if m else 0.0


def time_fn(fn: Callable, warmup: int = 2, iters: int = 5) -> float:
    """Median-of-iters wall time of fn() in seconds (outputs synchronised)."""
    return median(time_samples(fn, warmup, iters))


def bench_result(
    name: str,
    samples: List[float],
    items: int,
    bytes_per_item: int = 4,
    counters: Dict[str, float] | None = None,
) -> BenchResult:
    """The row of timed samples (seconds a call): the median, and the rates
    at the median."""
    sec = median(samples)
    return BenchResult(
        name=name,
        real_ms=sec * 1e3,
        items_per_s=items / sec,
        bytes_per_s=items * bytes_per_item / sec,
        iterations=len(samples),
        counters=counters or {},
    )


def run_benchmark(
    name: str,
    fn: Callable,
    items: int,
    bytes_per_item: int = 4,
    warmup: int = 2,
    iters: int = 5,
    counters: Dict[str, float] | None = None,
) -> BenchResult:
    return bench_result(name, time_samples(fn, warmup, iters), items, bytes_per_item, counters)


def device_set(device: str):
    """The entry points' DeviceSet: DeviceSet.allocate() for "cuda", which
    raises without a CUDA device; an explicit CPU set for "cpu", which only
    the tests and ``--device cpu`` ask for."""
    from ..parallel.mesh import DeviceSet

    return DeviceSet.allocate() if device == "cuda" else DeviceSet(torch.device("cpu"))


def card_missing(device: str, prog: str) -> bool:
    """True, with a message on stderr, when ``device`` is "cuda" and there
    is no CUDA device: the entry point then exits 1 and writes nothing."""
    if device == "cuda" and not torch.cuda.is_available():
        print(f"{prog} needs a CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return True
    return False
