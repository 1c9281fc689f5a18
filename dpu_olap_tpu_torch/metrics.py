"""Observability: operator logging, device profiling scopes and benchmark
counters (counterpart of ``dpu_olap_tpu/metrics.py``).

Reference (SURVEY §5.1, §5.5):
  * device cycle counters (perfcounter_config + nb_cycles readback,
    dpu/filter/main.c:38-49, host/dpuext/perf.cc) -> torch.profiler scopes
    (``trace`` below): the profiler reports each kernel's device time
    inside the named region instead of a raw cycle count;
  * Google Benchmark counters (bytes/items processed, per-phase ms
    normalized by rank count, join_benchmark.cc:48-60) -> ``Counters``,
    emitted as JSON lines (scripts/parse_results.py -> CSV);
  * ENABLE_LOG printf logging (shared/umq/log.h) -> ``log``/``device_log``
    gated on config.FLAGS;
  * the hot path's own spans and counters: ``trace`` opens a span at each
    step of a query (``dpu_olap.<layer>.<step>``) when a profiler runs, and
    ``count`` adds to a registry of plain ints (``readback.<site>``, the
    host readbacks of device scalars; ``exchange.copies``, ``.bytes`` and
    ``.collectives``, what the shuffle's exchanges moved), read as the
    difference of two ``counts()``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Dict

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from .config import FLAGS


def log(msg: str) -> None:
    """Operator-level logging (reference log(), shared/umq/log.h:6-11)."""
    if FLAGS.enable_log:
        print(f"[dpu_olap_tpu_torch] {msg}", file=sys.stderr, flush=True)


def device_log(tag: str, per_device_values, names=None) -> None:
    """One log line per device for small per-device diagnostic arrays of
    shape (n_devices, ...), gated on ENABLE_LOG (DpuSet::log analog)."""
    if not FLAGS.enable_log:
        return
    vals = np.asarray(per_device_values)
    if vals.ndim == 1:
        vals = vals[:, None]
    vals = vals.reshape(vals.shape[0], -1)
    for dev in range(vals.shape[0]):
        row = vals[dev]
        if names:
            body = " ".join(f"{n}={v}" for n, v in zip(names, row))
        else:
            body = " ".join(str(v) for v in row)
        print(f"[dev {dev}] {tag}: {body}", file=sys.stderr, flush=True)


_OFF = contextlib.nullcontext()  # every span when no profiler runs
_COUNTS: Dict[str, int] = {}


def trace(name: str, trace_dir: str | None = None):
    """A span named ``name`` (the perfcounter analog; the JAX package's
    jax.profiler.trace + TraceAnnotation): a ``record_function(name)`` while
    a ``torch.profiler`` runs, so that the profiler puts the region and the
    device work launched in it on its own clock, and one shared no-op
    otherwise, which costs a flag test. With ``trace_dir`` set and
    FLAGS.enable_perf, it profiles the region itself on the CPU and, where
    there is one, the CUDA device, and writes a Chrome trace
    ``<name>.<pid>.json`` into ``trace_dir``; the path is then yielded (None
    otherwise)."""
    if trace_dir and FLAGS.enable_perf:
        return _exported(name, trace_dir)
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


@contextlib.contextmanager
def _exported(name: str, trace_dir: str):
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.{os.getpid()}.json")
    with profile(activities=acts) as prof:
        with record_function(name):
            yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter ``name``: a plain int, no device work."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> Dict[str, int]:
    """A copy of every counter; what a stretch of work counted is the
    difference of the copies taken before and after it."""
    return dict(_COUNTS)


class Counters:
    """Benchmark counter registry -> one JSON object (Google Benchmark
    counter emission analog)."""

    def __init__(self, name: str):
        self.name = name
        self.values: Dict[str, float] = {}

    def set(self, key: str, value: float) -> "Counters":
        self.values[key] = float(value)
        return self

    def rate(self, key: str, items: int, seconds: float) -> "Counters":
        self.values[key] = items / seconds
        return self

    def items_processed(self, n: int, seconds: float, bytes_per_item: int = 4):
        self.values["items_per_s"] = n / seconds
        self.values["bytes_per_s"] = n * bytes_per_item / seconds
        self.values["real_ms"] = seconds * 1e3
        return self

    def timers(self, timers, names, rank_normalize: bool = True) -> "Counters":
        """Fold phase timers in, normalized by rank count like the reference
        (join_benchmark.cc:48-60)."""
        for n in names:
            ms = timers.sum_ms(n)
            ranks = max(1, timers.rank_count(n)) if rank_normalize else 1
            self.values[f"{n}_ms"] = ms / ranks
        return self

    def to_json(self) -> str:
        return json.dumps({"name": self.name, **self.values})

    def emit(self, file=None) -> None:
        print(self.to_json(), file=file or sys.stdout, flush=True)
