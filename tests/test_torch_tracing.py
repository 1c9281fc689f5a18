"""The port's spans and counters (dpu_olap_tpu_torch.metrics ``trace``,
``count``, ``counts``) on the CPU: under a running ``torch.profiler`` the
steps of a query open their spans (``dpu_olap.<layer>.<step>``), once a
query and nested as the plan nests them; the host readbacks of the plan's
device tier and of the shuffle join's overflow vote are counted where they
happen, and the exchange counts the bytes it delivered; with no profiler
running a span is one shared no-op that enters no RecordFunction.

The shuffle join's ranks (two gloo ranks, ``process_group.spawn``) import
this module to find their function."""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dpu_olap_tpu_torch import metrics, plan
from dpu_olap_tpu_torch.columnar import Batch, Table
from dpu_olap_tpu_torch.parallel import process_group as pg
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

BATCH, BATCHES = 512, 4  # a small cell 1: several batches a side
# The spans one query of Aggregate(HashJoin(Source, Source)) opens, with
# how often: one a plan node (two Sources), one a step of the device tier
# and of the sorted-build join, none a batch. With keys31 the compaction
# runs inside the join's last step, so no dpu_olap.plan.compact.
QUERY_SPANS = {
    "dpu_olap.plan.Aggregate": 1, "dpu_olap.plan.HashJoin": 1, "dpu_olap.plan.Source": 2,
    "dpu_olap.plan.dtypes": 1, "dpu_olap.plan.concat": 1, "dpu_olap.plan.structure": 1,
    "dpu_olap.plan.sum": 1,
    "dpu_olap.join.keys": 1, "dpu_olap.join.sort": 1, "dpu_olap.join.merge": 1,
    "dpu_olap.join.fill_match": 1,
}
QUERY_READBACKS = {"readback.plan.keys31": 2, "readback.plan.pk_sorted": 1,
                   "readback.plan.compact": 1, "readback.aggregate.u64": 2}
DIST_SPANS = {"dpu_olap.dist.partition": 2, "dpu_olap.dist.exchange": 2,
              "dpu_olap.dist.join": 1, "dpu_olap.dist.vote": 1}
ROUNDS = 2  # the shuffle join's rounds a rank, as on four cards at SF=256


def _join_columns(n, seed):
    """BM_JoinDpu's columns: pk sequential, fk uniform in its batch's pk
    range, payloads random; uint32."""
    rng = np.random.default_rng(seed)
    pk = np.arange(n, dtype=np.uint32)
    lo = np.arange(n) // BATCH * BATCH
    fk = (lo + rng.integers(0, BATCH, n)).astype(np.uint32)
    y, x = (rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(2))
    return fk, y, pk, x


def _table(names, cols):
    return Table([Batch({n: torch.from_numpy(c[i:i + BATCH]) for n, c in zip(names, cols)})
                  for i in range(0, cols[0].shape[0], BATCH)])


@pytest.fixture(scope="module")
def cell():
    fk, y, pk, x = _join_columns(BATCH * BATCHES, seed=7)
    want = int(x[fk].astype(np.uint64).sum())
    return _table(("fk", "y"), (fk, y)), _table(("pk", "x"), (pk, x)), want


def _query(cell):
    left, right, _ = cell
    return plan.Aggregate(plan.HashJoin(plan.Source(left), plan.Source(right)), "x").scalar(
        DeviceSet("cpu"))


def _spans(prof):
    """(name, start, end) of the program's spans the profiler recorded."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("dpu_olap.")]


def _delta(before, after, prefix):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith(prefix) and v != before.get(k, 0)}


def test_query_opens_each_span_once_a_query_nested_as_the_plan(cell):
    queries = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [_query(cell) for _ in range(queries)]
    assert got == [cell[2]] * queries
    spans = _spans(prof)
    assert Counter(n for n, _, _ in spans) == {k: v * queries for k, v in QUERY_SPANS.items()}

    def within(name, outer):
        inner = [(s, e) for n, s, e in spans if n.startswith(name)]
        parents = [(s, e) for n, s, e in spans if n == outer]
        return all(any(ps <= s and e <= pe for ps, pe in parents) for s, e in inner)

    assert within("dpu_olap.join.", "dpu_olap.plan.HashJoin")
    for step in ("dtypes", "concat", "structure", "Source"):
        assert within(f"dpu_olap.plan.{step}", "dpu_olap.plan.HashJoin")
    assert within("dpu_olap.plan.HashJoin", "dpu_olap.plan.Aggregate")
    assert within("dpu_olap.plan.sum", "dpu_olap.plan.Aggregate")
    assert not within("dpu_olap.plan.sum", "dpu_olap.plan.HashJoin")


@pytest.mark.parametrize("profiled", [False, True])
def test_query_counts_its_six_readbacks(cell, profiled):
    before = metrics.counts()
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        assert _query(cell) == cell[2]
    got = _delta(before, metrics.counts(), "readback.")
    assert got == QUERY_READBACKS and sum(got.values()) == 6


def test_query_counts_one_fill_match(cell):
    """The plan's device tier joins with keys31 through the fused fill,
    match and compaction: one step a query, and the padded step never."""
    queries = 2
    before = metrics.counts()
    assert [_query(cell) for _ in range(queries)] == [cell[2]] * queries
    assert _delta(before, metrics.counts(), "join.") == {"join.fill_match_compact": queries}


def test_span_off_is_one_shared_noop(cell, monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    off = metrics.trace("dpu_olap.a")
    assert off is metrics.trace("dpu_olap.b") and isinstance(off, contextlib.nullcontext)

    def entered(name):
        raise AssertionError(f"a RecordFunction was entered for {name}")

    monkeypatch.setattr(metrics, "record_function", entered)
    with off as value:
        assert value is None
    assert _query(cell) == cell[2]  # a whole query enters none


def test_span_on_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = metrics.trace("dpu_olap.test.on")
        assert isinstance(span, torch.autograd.profiler.record_function)
        with span:
            torch.arange(8).sum()
    assert [n for n, _, _ in _spans(prof)] == ["dpu_olap.test.on"]


def _rank_join(gs, n):
    """One rank of the shuffle join, profiled: its spans' names, what the
    counters counted, the bytes of the blocks its exchanges received, and
    its matched rows."""
    from dpu_olap_tpu_torch.parallel.dist_join import dist_join_retry

    torch.set_num_threads(1)
    fk, y, pk, x = (torch.from_numpy(c) for c in _join_columns(n * gs.world_size, seed=11))
    rows = slice(gs.rank * n, (gs.rank + 1) * n)
    exchange, received = gs.exchange, []

    def counted_exchange(blocks, *args, **kw):
        out = exchange(blocks, *args, **kw)
        received.extend(b.numel() * b.element_size() for b in out)
        return out

    gs.exchange = counted_exchange
    before = metrics.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, _ = dist_join_retry(gs, (fk[rows],), ((y[rows],),), (pk[rows],), ((x[rows],),),
                                 keys31=True, rounds=ROUNDS)
    counted = metrics.counts()
    names = [n for n, _, _ in _spans(prof)]
    return names, _delta(before, counted, ""), sum(received), int(out[3][0].sum())


def test_shuffle_join_spans_vote_and_exchange_bytes():
    n = 2 * BATCH
    ranks = pg.spawn(_rank_join, 2, args=(n,), backend="gloo", device="cpu")
    assert sum(matched for *_, matched in ranks) == 2 * n  # every probe row matches
    for names, counted, received, _ in ranks:
        assert Counter(x for x in names if x.startswith("dpu_olap.dist.")) == DIST_SPANS
        # the join's steps, once in each of the rank's rounds
        assert Counter(x for x in names if x.startswith("dpu_olap.join.")) == {
            "dpu_olap.join.sort": ROUNDS, "dpu_olap.join.fill_match": ROUNDS}
        assert counted["join.fill_match"] == ROUNDS
        assert "join.fill_match_compact" not in counted  # the shuffle join keeps its padding
        assert {k: v for k, v in counted.items() if k.startswith("readback.")} == {
            "readback.group.any": 1}
        # two exchanges a side (the stacked planes, the counts), one collective each
        assert counted["exchange.collectives"] == 4 and counted["exchange.copies"] == 4
        assert counted["exchange.bytes"] == received > 0
