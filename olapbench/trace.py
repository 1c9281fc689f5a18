"""From a ``torch.profiler`` run over a slice of the window to plain numbers.

The harness opens ``olapbench.slice`` around the traced queries (it ends
after the device has finished them) and ``olapbench.query`` around each.
``summarize`` keeps, of the events inside the slice, each device operation
as (start us, end us, name, kind) and the device's idle gaps labelled by
what the host was doing, so the per-layer readers (``metrics/``) and the
breakdown need no profiler object. Kinds: ``copy`` (Memcpy), ``memset``,
``comm`` (NCCL kernels), ``port`` (a kernel outside torch's, cub's and
thrust's namespaces whose name holds one of the program's own ``__global__``
functions, read from its CUDA sources) and ``glue`` (every other kernel).

Busy time is the union of the device's intervals, copies included, and the
idle share one minus busy over the slice's length (the arithmetic of
``chip_smoke.profile_run`` in the program's repository, copied here).
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import re
from pathlib import Path

SLICE = "olapbench.slice"
QUERY = "olapbench.query"
NAME_CHARS = 120  # a breakdown entry's name is cut to this length
HOST_SCAN = 256  # host events looked back over to label one gap
LIBRARIES = ("at::", "at_cuda_detail", "cub::", "thrust::", "c10::")  # never the program's

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


@dataclasses.dataclass
class Trace:
    """One process's traced slice."""

    rank: int
    queries: int
    span_us: float  # the slice's length
    device: list  # (start_us, end_us, name, kind), clipped to the slice
    gaps: list  # (host label, idle us), one an idle gap
    least_bytes: int  # the bytes one query needs on this chip (the roofline)

    @property
    def busy_us(self) -> float:
        return union_us([(s, e) for s, e, _, _ in self.device])

    def kind_us(self, *kinds) -> float:
        return sum(e - s for s, e, _, k in self.device if k in kinds)

    def count(self, prefix: str) -> int:
        return sum(1 for _, _, n, _ in self.device if n.startswith(prefix))


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        total += max(0.0, e - max(s, end))
        end = max(end, e)
    return total


def idle_spans(spans, lo: float, hi: float) -> list:
    """The (start, end) gaps in [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for s, e in sorted(spans):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(s, e) for s, e in gaps if e > s]


def port_kernels(package: str = "dpu_olap_tpu_torch") -> frozenset:
    """The names of the program's own CUDA kernels (its ``csrc`` sources)."""
    spec = importlib.util.find_spec(package)
    if spec is None or spec.origin is None:
        return frozenset()
    names = set()
    for src in (Path(spec.origin).parent / "csrc").glob("*.cu*"):
        names.update(_GLOBAL.findall(src.read_text()))
    return frozenset(names)


def kind_of(name: str, port) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    if name.lower().startswith("nccl"):
        return "comm"
    if any(lib in name for lib in LIBRARIES):
        return "glue"
    if port and set(re.findall(r"\w+", name)) & port:
        return "port"
    return "glue"


def _label(host, starts, t: float) -> str:
    """The innermost host event running at time t: the latest-starting one
    that has not ended."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - HOST_SCAN, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "host (no op)"


def summarize(events, rank: int, least_bytes: int, port=frozenset()) -> Trace:
    """Reduce profiler events (``prof.events()``) to a Trace of the slice."""
    from torch.autograd import DeviceType

    spans = [e for e in events if e.name == SLICE and e.device_type == DeviceType.CPU]
    if not spans:
        raise ValueError("the trace holds no olapbench.slice span")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    queries, device, host = 0, [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith("olapbench."):
            if e.name == QUERY and e.device_type == DeviceType.CPU and lo <= s <= hi:
                queries += 1
            continue
        if t < lo or s > hi:
            continue
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            device.append((max(s, lo), min(t, hi), e.name, kind_of(e.name, port)))
        elif e.device_type == DeviceType.CPU:
            host.append((s, t, e.name))
    host.sort()
    starts = [h[0] for h in host]
    gaps = [(_label(host, starts, (s + e) / 2), e - s)
            for s, e in idle_spans([(s, e) for s, e, _, _ in device], lo, hi)]
    return Trace(rank, queries, hi - lo, device, gaps, least_bytes)


def _top(pairs) -> list:
    acc: dict = {}
    for name, us in pairs:
        key = name[:NAME_CHARS]
        acc[key] = acc.get(key, 0.0) + us
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:10]
    return [[name, us / 1e6] for name, us in top]


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing, in seconds (at most 10 entries each)."""
    return {"device_ops": _top((n, e - s) for s, e, n, _ in trace.device),
            "idle_gaps": _top(trace.gaps)}
