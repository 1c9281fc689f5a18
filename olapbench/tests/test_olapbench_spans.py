"""The program's spans in a traced slice (``spans.py``): on synthetic events
that carry the profiler's ids, a device operation goes to the span that
launched it, whenever it runs, and idle time is split by a sweep over the
spans; then one query of the one-chip cell traced by the harness's loop, on
the CPU and, marked ``cuda``, on the card."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from olapbench import harness, spans, spec, trace as tracing

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, linked=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=id, linked_correlation_id=linked,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def launched_events():
    """One query: the sort span launches a kernel that runs after the span
    has closed on the host; an operator in the fill span launches a copy
    that only the operator link names; a kernel's launch lies outside every
    span."""
    return [
        ev(tracing.SLICE, 0.0, 100.0, annotation=True),
        ev(tracing.QUERY, 0.0, 100.0, annotation=True),
        ev("dpu_olap.plan.HashJoin", 5.0, 60.0, id=1, annotation=True),
        ev("dpu_olap.join.sort", 10.0, 20.0, id=2, annotation=True),
        ev("cudaLaunchKernel", 12.0, 13.0, id=101),
        ev("dpu_olap.join.fill", 20.0, 50.0, id=3, annotation=True),
        ev("aten::copy_", 22.0, 23.0, id=4),
        ev("cudaLaunchKernel", 70.0, 71.0, id=103),
        ev("sort_kernel", 30.0, 40.0, CUDA, id=101),
        ev("Memcpy DtoD", 41.0, 45.0, CUDA, id=102, linked=4),
        ev("fill_kernel", 72.0, 80.0, CUDA, id=103),
        ev("dpu_olap.join.sort", 30.0, 40.0, CUDA, id=2, annotation=True),  # device copy of a span
    ]


def test_a_device_op_goes_to_the_span_that_launched_it():
    s = spans.summarize(launched_events(), rank=0)
    assert s.queries == 1
    assert [(n, q) for _, _, n, q in s.spans] == [
        ("dpu_olap.plan.HashJoin", 0), ("dpu_olap.join.sort", 0), ("dpu_olap.join.fill", 0)]
    # the sort kernel ran at 30-40, inside the fill span on the host's clock
    assert s.launched == [(30.0, 40.0, "sort_kernel", "dpu_olap.join.sort"),
                          (41.0, 45.0, "Memcpy DtoD", "dpu_olap.join.fill"),
                          (72.0, 80.0, "fill_kernel", spans.OUTSIDE)]
    assert s.launched_us("dpu_olap.join.sort") == 10.0
    assert s.launched_us("dpu_olap.join.") == 14.0 and s.launched_us("dpu_olap.dist.") == 0.0


def test_idle_sweep_splits_a_gap_across_spans_and_outside():
    s = spans.summarize(launched_events(), rank=0)
    # idle: 0-30, 40-41, 45-72, 80-100. Host: outside 0-5, HashJoin 5-10,
    # sort 10-20, fill 20-50, HashJoin 50-60, outside 60-100
    assert s.idle == pytest.approx({
        spans.OUTSIDE: 5 + 12 + 20, "dpu_olap.plan.HashJoin": 5 + 10,
        "dpu_olap.join.sort": 10, "dpu_olap.join.fill": 10 + 1 + 5})
    assert sum(s.idle.values()) == pytest.approx(100 - 10 - 4 - 8)
    assert s.idle_us("dpu_olap.join.") == pytest.approx(26)
    assert s.idle_us("dpu_olap.plan.") == pytest.approx(15)


def test_segments_nest_and_clip():
    segs = spans.segments([(0, 30, "a"), (5, 15, "b"), (30, 60, "c"), (70, 120, "d")], 10, 100)
    assert segs == [(10, 15, "b"), (15, 30, "a"), (30, 60, "c"), (60, 70, spans.OUTSIDE),
                    (70, 100, "d")]
    assert spans.segments([], 0, 5) == [(0, 5, spans.OUTSIDE)]
    assert spans.split_idle([(12, 65)], segs) == {"b": 3, "a": 15, "c": 30, spans.OUTSIDE: 5}


def test_a_trace_without_program_spans():
    t = [e for e in launched_events() if not e.name.startswith(spans.PREFIX)]
    s = spans.summarize(t, rank=0)
    assert s.spans == [] and {label for *_, label in s.launched} == {spans.OUTSIDE}
    assert set(s.idle) == {spans.OUTSIDE} and not s.has(spans.PREFIX)
    assert s.idle_us("dpu_olap.") == 0.0 and s.launched_us("dpu_olap.") == 0.0


def traced_query(device, rows):
    """One query of the one-chip cell at a reduced size, traced by the
    harness's own loop: the program's Spans, the trace's summary and what
    the program's counters counted."""
    import torch

    from dpu_olap_tpu_torch import metrics
    from olapbench.tests.cells import ctx_of

    _, ctx = ctx_of("bm_join_sf128-join_sum", trace=True, device=device, rows=rows)
    env = harness.Env(ctx, torch.device(device))
    q = spec.query_module(ctx.traffic["query"])
    state = q.setup(env)
    q.query(state, False)  # warm-up
    before = metrics.counts()
    lat, _, _, error, prof = harness.closed_loop(q.query, state, 0.0, env.device, 1)
    counted = {k: v - before.get(k, 0) for k, v in metrics.counts().items()
               if k.startswith("readback.") and v != before.get(k, 0)}
    assert error is None and len(lat) == 1
    events = prof.events()
    return spans.summarize(events, 0), tracing.summarize(events, 0, 1), counted


def test_a_traced_query_on_the_cpu():
    s, t, counted = traced_query("cpu", 1 << 12)
    names = [n for _, _, n, _ in s.spans]
    assert s.queries == 1 and {q for *_, q in s.spans} == {0}
    assert names.count("dpu_olap.plan.Source") == 2 and names.count("dpu_olap.join.sort") == 1
    assert s.launched == [] and sum(s.idle.values()) == pytest.approx(t.span_us)
    assert s.idle_us("dpu_olap.") > 0.5 * t.span_us  # the host works inside the spans
    assert sum(counted.values()) == 6


@pytest.mark.cuda
def test_spans_on_the_card():
    """On the card: the six counted readbacks are the six DtoH copies, and
    the program's spans launched nearly all of the device work."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only there")
    s, t, counted = traced_query("cuda:0", 1 << 21)
    assert sum(counted.values()) == t.count("Memcpy DtoH") == 6
    outside = sum(e - b for b, e, _, span in s.launched if span == spans.OUTSIDE)
    assert s.launched and outside <= 0.1 * sum(e - b for b, e, _, _ in s.launched)
    assert s.idle.get(spans.OUTSIDE, 0.0) <= 0.1 * sum(s.idle.values())
