"""The program's own spans in a traced slice, and what they say of the device.

The program (``dpu_olap_tpu_torch``) opens a ``record_function`` span at each
step of a query while a profiler runs, named ``dpu_olap.<layer>.<step>``
(``dpu_olap.plan.HashJoin``, ``dpu_olap.join.sort``, ``dpu_olap.dist.exchange``,
...). ``summarize`` keeps, of the events inside the harness's
``olapbench.slice``:

  * the spans: (start us, end us, name, index of the ``olapbench.query`` they
    lie in);
  * each device operation with the innermost span that launched it, found by
    the launch and not by time (the host runs ahead of the device): the
    device event shares its correlation id with the runtime call that
    launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, NCCL's launch),
    and the span is the one open on the host when that call started; where
    the profiler links the device event to the operator that launched it
    (``linked_correlation_id``), that operator's start stands in;
  * the device's idle time split by the innermost span open on the host
    over it, by a sweep over the spans' edges, ``outside`` where none is.

The idle gaps and unions are ``trace.py``'s. A program without spans gives
empty lists. The harness does not call it, so the result line carries none
of it; a traced slice's events come from ``harness.closed_loop``'s
profiler:

    lat, answers, window, error, prof = harness.closed_loop(
        q.query, state, seconds, device, trace_queries)
    s = spans.summarize(prof.events(), rank)
    s.idle_us("dpu_olap.plan."), s.launched_us("dpu_olap.dist.exchange")
"""

from __future__ import annotations

import bisect
import dataclasses

from .trace import NAME_CHARS, QUERY, SLICE, idle_spans, union_us

PREFIX = "dpu_olap."  # the program's spans
OUTSIDE = "outside"  # no program span open
RUNTIME = "cu"  # the CUDA API's launch and copy calls: cudaLaunchKernel, cuLaunchKernelEx, ...


@dataclasses.dataclass
class Spans:
    """One process's traced slice as the program's spans see it."""

    rank: int
    queries: int
    spans: list  # (start_us, end_us, name, query index), by start
    launched: list  # (start_us, end_us, device op name, span name or OUTSIDE), clipped to the slice
    idle: dict  # innermost span name, or OUTSIDE: device idle us under it

    def has(self, prefix: str) -> bool:
        """Whether a span of this name or prefix lies in the slice."""
        return any(name.startswith(prefix) for _, _, name, _ in self.spans)

    def idle_us(self, prefix: str) -> float:
        """Device idle time under the spans of this name or prefix."""
        return sum(us for name, us in self.idle.items() if name.startswith(prefix))

    def launched_us(self, prefix: str) -> float:
        """The union of the device operations launched under the spans of
        this name or prefix."""
        return union_us([(s, e) for s, e, _, span in self.launched if span.startswith(prefix)])


def segments(spans, lo: float, hi: float) -> list:
    """[lo, hi] cut at the spans' edges: (start, end, label) pieces in
    order, each labelled with the innermost span open over it (the latest
    started that has not ended; spans of one thread nest) or OUTSIDE."""
    out, open_, t = [], [], lo

    def upto(end, label):
        nonlocal t
        end = min(max(end, lo), hi)
        if end > t:
            out.append((t, end, label))
            t = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while open_ and open_[-1][0] <= s:
            end, label = open_.pop()
            upto(end, label)
        upto(s, open_[-1][1] if open_ else OUTSIDE)
        open_.append((e, name))
    while open_:
        end, label = open_.pop()
        upto(end, label)
    upto(hi, OUTSIDE)
    return out


def label_at(segs, starts, t: float) -> str:
    """The label of the piece of segs (starts: their starts) that holds t."""
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else OUTSIDE


def split_idle(gaps, segs) -> dict:
    """Each gap's length, split over the pieces it overlaps, by label."""
    idle: dict = {}
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, label = segs[k]
            idle[label] = idle.get(label, 0.0) + min(b, e) - max(a, s)
            k += 1
    return idle


def summarize(events, rank: int) -> Spans:
    """Reduce profiler events (``prof.events()``) to the program's Spans of
    the slice."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    slices = [e for e in events if e.name == SLICE and e.device_type == cpu]
    if not slices:
        raise ValueError("the trace holds no olapbench.slice span")
    lo, hi = slices[0].time_range.start, slices[0].time_range.end
    queries = sorted(e.time_range.start for e in events
                     if e.name == QUERY and e.device_type == cpu
                     and lo <= e.time_range.start <= hi)
    spans, runtime, operators, device = [], {}, {}, []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cpu:
            if e.name.startswith(PREFIX) and lo <= s <= hi:
                spans.append((s, t, e.name))
            if e.name.startswith(RUNTIME):
                runtime[e.id] = s
            else:  # an operator, or an event inside one that shares its id
                operators[e.id] = min(s, operators.get(e.id, s))
        elif e.device_type == cuda and not getattr(e, "is_user_annotation", False):
            if t >= lo and s <= hi:
                device.append((max(s, lo), min(t, hi), e))
    segs = segments(spans, lo, hi)
    starts = [p[0] for p in segs]
    launched = []
    for s, t, e in device:
        at = runtime.get(e.id)
        if at is None:
            at = operators.get(getattr(e, "linked_correlation_id", 0) or None)
        label = OUTSIDE if at is None else label_at(segs, starts, at)
        launched.append((s, t, e.name[:NAME_CHARS], label))
    spans.sort()
    kept = [(s, t, name, bisect.bisect_right(queries, s) - 1) for s, t, name in spans]
    idle = split_idle(idle_spans([(s, t) for s, t, _ in device], lo, hi), segs)
    return Spans(rank, len(queries), kept, launched, idle)
