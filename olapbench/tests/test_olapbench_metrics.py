"""The per-layer and end-to-end arithmetic on synthetic events: busy time as
a union, idle share, glue share, the roofline, copies a query, the p95 over
every query and the rate over the whole window."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from olapbench import harness, roofline, spec, trace as tracing

PORT = frozenset({"digit_pass_kernel", "fill_kernel"})


def ev(name, start, end, device=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def synthetic_events():
    cpu = DeviceType.CPU
    return [
        ev(tracing.SLICE, 0.0, 100.0, cpu),
        ev(tracing.QUERY, 0.0, 50.0, cpu), ev(tracing.QUERY, 50.0, 100.0, cpu),
        ev("aten::where", 8.0, 12.0, cpu), ev("aten::item", 55.0, 80.0, cpu),
        ev("void (anonymous namespace)::digit_pass_kernel<1>(unsigned int const*)", 0.0, 10.0),
        ev("void at::native::elementwise_kernel<128, 2>(int)", 5.0, 20.0),  # overlaps
        ev("Memcpy DtoH (Device -> Pageable)", 30.0, 31.0),
        ev("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", 40.0, 50.0),
        ev("Memset (Device)", 60.0, 61.0),
        ev("fill_kernel<2, false>(InPlanes)", 90.0, 110.0),  # clipped at 100
        ev("olapbench.query", 0.0, 50.0, annotation=True),  # gpu annotation: not work
        ev("Memcpy DtoH (Device -> Pinned)", 200.0, 210.0),  # outside the slice
    ]


def test_summarize_keeps_the_slice_and_labels_idle_time():
    t = tracing.summarize(synthetic_events(), rank=0, least_bytes=1000, port=PORT)
    assert t.queries == 2 and t.span_us == 100.0
    kinds = sorted(k for *_, k in t.device)
    assert kinds == ["comm", "copy", "glue", "memset", "port", "port"]
    assert t.busy_us == pytest.approx(20 + 1 + 10 + 1 + 10)  # [0,20] 30-31 40-50 60-61 90-100
    # idle 20-30, 31-40, 50-60 and 61-90, each named by the host op at its middle
    assert sorted(t.gaps) == [("aten::item", 10.0), ("aten::item", 29.0),
                              ("host (no op)", 9.0), ("host (no op)", 10.0)]
    b = tracing.breakdown(t)
    assert b["device_ops"][0][1] == pytest.approx(15e-6) and len(b["idle_gaps"]) <= 10


def run_of(traces, latencies=(0.01,), window=1.0, probe_rows=100, peak=2**30):
    ranks = [{"latencies_s": list(latencies), "window_s": window, "peak_bytes": peak,
              "trace": t} for t in traces] or [{"latencies_s": list(latencies),
                                                "window_s": window, "peak_bytes": peak}]
    return harness.Run(ranks, 12.5, probe_rows)


def read(name, run):
    return spec.metric_reader(name)(run)


def test_per_layer_readers():
    t = tracing.summarize(synthetic_events(), rank=0, least_bytes=1000, port=PORT)
    run = run_of([t, t])
    assert read("device_idle_share", run) == pytest.approx(100 * (1 - 42 / 100))
    assert read("glue_device_share", run) == pytest.approx(100 * 15 / (15 + 10 + 10))
    assert read("dtoh_syncs_per_query", run) == 0.5
    assert read("exchange_ms_per_query", run) == pytest.approx(10 / 1e3 / 2)
    least_us = 2 * 1000 / roofline.HBM_BYTES_PER_S * 1e6
    assert read("query_roofline", run) == pytest.approx(100 * least_us / 42)


def test_readers_with_nothing_to_read_return_none():
    run = run_of([])
    for name in ("device_idle_share", "glue_device_share", "dtoh_syncs_per_query",
                 "exchange_ms_per_query", "query_roofline"):
        assert read(name, run) is None
    quiet = tracing.Trace(0, 3, 10.0, [(0.0, 5.0, "fill_kernel", "port")], [], 0)
    assert read("exchange_ms_per_query", run_of([quiet])) is None
    assert read("query_roofline", run_of([quiet])) is None  # no bytes: no share, never 0


def test_p95_over_every_query_and_the_rate_over_the_whole_window():
    lat = [0.001 * i for i in range(1, 101)]  # 1 .. 100 ms
    assert harness.p95(lat) == pytest.approx(0.095)
    assert harness.p95([0.5]) == 0.5
    assert harness.p95([0.002, 0.001, 0.003]) == 0.003
    run = run_of([], latencies=lat, window=2.5, probe_rows=64)
    assert read("query_p95_ms", run) == pytest.approx(95.0)
    assert read("query_rows_per_s", run) == pytest.approx(100 * 64 / 2.5)
    assert read("setup_s", run) == 12.5
    assert read("device_gib_peak", run) == 1.0


def test_union_and_idle_spans():
    spans = [(0, 10), (5, 20), (30, 40), (35, 36)]
    assert tracing.union_us(spans) == 30
    assert tracing.idle_spans(spans, 0, 50) == [(20, 30), (40, 50)]
    assert tracing.idle_spans([], 0, 5) == [(0, 5)]


def test_port_kernel_names_come_from_the_program_sources():
    names = tracing.port_kernels()
    assert {"digit_pass_kernel", "fill_kernel", "merge_pass_kernel", "sum_u32_kernel"} <= names
    assert "__launch_bounds__" not in names
    assert tracing.kind_of("void at::native::vectorized_elementwise_kernel<4>()", names) == "glue"
    assert tracing.kind_of("void (anonymous namespace)::merge_pass_kernel<1>(int)", names) == "port"
    # a library kernel whose name holds a token like one of the program's stays glue
    torch_where = ("void at::native::elementwise_kernel<128, 2, at::native::"
                   "where_kernel(at::TensorIterator&)::{lambda()#1}>(int)")
    assert "where_kernel" in names and tracing.kind_of(torch_where, names) == "glue"
