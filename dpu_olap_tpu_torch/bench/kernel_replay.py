"""Device time of the port's redesigned kernels as CUDA-graph replays,
beside the PyTorch call that does the same work, and the per-launch
breakdown of the partition, the forward fill and the filter.

    python -m dpu_olap_tpu_torch.bench.kernel_replay [--label NAME] [--out FILE] [--only GROUP ...]

Inputs are drawn on the card from seed 42:
  * sort: ``sort_cuda.sort_bitonic`` of a random u32 key with one payload
    at 2Mi and 16Mi rows (the dense join at SF=1 and SF=8) beside
    ``torch.sort`` of the key's int32 view;
  * gather: ``take_cuda.gather_sorted`` of 2Mi or 16Mi ascending queries
    (about 1/65 of them past the table) beside ``torch.index_select``
    (those clipped);
  * merge_probe: ``merge_cuda.merge_probe`` with one payload at 2Mi x 2Mi,
    1Mi x 1Mi (the hashtable micro) and 1 x 2Mi (one probe key against the
    whole store), sorted keys below 2^31, beside
    ``torch.searchsorted(right=True)`` of the int32 views;
  * partition: ``partition_cuda.partition_cells`` at 16Mi + 1 payload +
    selection into P = 8 cells of 4Mi (partition_kernel_p8 at SF=8) and at
    128Mi + 1 payload into P = 2 cells of 128Mi without the selection (one
    side of the SF=64 shuffle join), beside a stable ``torch.sort`` of the
    int32 bucket. Each shape also gets a per-launch breakdown: the device
    events of BREAKDOWN_CALLS eager calls under torch.profiler, summed by
    name and divided by the calls;
  * fill: ``scan_cuda.propagate_fill`` of a key + 1 payload at 8Mi lanes
    with a live density of 0.18 (chip_smoke.py's timed fill, the TPC-H
    merge's share of pk rows) and at one SF=64 shuffle round's shape
    (256Mi lanes: the round's co-sorted packed keys, built as
    chip_smoke.py's ``phase_round_kernels`` builds them), and
    ``propagate_last`` of one plane at 8Mi on the same mask. No PyTorch
    call computes a segmented forward fill: no library reading. Both fill
    shapes get a per-launch breakdown;
  * filter: ``filter_cuda.filter_compact`` and ``filter_with_indices`` (v1)
    and ``filter_alt_cuda``'s v2, v3 and v4, compact and with indices, of
    64Mi uniform uint32 values (one filter round at SF=8, chip_smoke.py's
    ``_filter_inputs``; a quarter kept), every stage of
    ``filter_stages.STAGES`` (the package's own list) and ``clone`` (the
    copy stage's yardstick), beside the predicate + ``torch.masked_select``
    (eager: its output length is read back to the host, so it cannot be
    captured), with the per-launch breakdowns of v1's compaction, each
    alternate compact and with indices, each stage and the clone;
  * merge: ``merge.bitonic_merge`` at the sorted-build join's call on the
    TPC-H SF=1 key shape (1.5M sorted ``o_orderkey << 1`` rows, the pad,
    then 5,996,462 ``l_orderkey << 1 | 1`` rows descending: one 8Mi block,
    one merged payload plane) and ``bitonic_cuda.bitonic_merge_blocks`` at
    8Mi in 64Ki blocks of keys below 16, beside ``torch.sort`` of the 8Mi
    key's int32 view (a yardstick: a sort is not the same function), each
    with a per-launch breakdown;
  * tiles: ``sort_cuda.sort_tiles`` at 2Mi + 1 payload (measure_filter's
    sort section) beside ``torch.sort`` of the key's 4096-element rows,
    with a per-launch breakdown;
  * sum: ``sum_cuda.sum_u64_pair`` at 16Mi (one sum round at SF=8) beside
    ``x.sum(dtype=torch.int64)``, with a per-launch breakdown;
  * cops: ``block_ops_cuda.block_op(x, idx, "count_matmul", reps)`` on 128
    (128, 128) int32 tiles (measure_filter's cops section) at reps 0, 1
    and 16, so that the readings split a call into a fixed cost and a cost
    a rep, beside the plain version's torch chain at reps 16 (a bf16
    batched matmul of the 0/1 planes a rep), with the per-launch breakdown
    at each reps; values in [-2^14, 2^14) with half the indices equal to
    (v >> 7) & 127, so that the products are not all 0;
  * block_ops: ``block_ops_cuda.block_op(x, idx, op, reps)`` for the eight
    ops other than count_matmul at BLOCK_N = 2Mi int32 values (64 (256,
    128) blocks for the ops section's five, 128 (128, 128) tiles for the
    cops section's three) at reps 0, 1 and 16, so that the readings split
    each op into a fixed cost and a cost a rep, beside the plain version's
    torch chain at reps 16, each kernel reading with its per-launch
    breakdown; values over the whole int32 range and indices in [0, 128),
    as the probes draw them. Each op at reps 16 is also read L2-cold
    (``{op}_cold_r16``): the CALLS calls of the graph each take an x and idx
    of their own, 160 MiB in all, so that between two reads of one input
    the other calls move 216 MiB through the 50 MB L2;
  * lane_gather: ``probes_cuda.lane_gather`` at measure_r3's two gk shapes,
    8192 and 32768 rows of 128 int32 gathered at 128 indices a row, and at
    the wide lowering probe's 128 rows of 256 indices over 128 values,
    beside ``torch.gather`` (int64 indices, clamped), each with a
    per-launch breakdown;
  * probes: the lowering probes' seven calls at their shapes (the
    transposes of (128, 128) u32 and i32 and (512, 128) u32, the wide
    gather, the one-hot product (128, 128)^T @ (128, 256), dyn_row at rows
    317 and -1 of (512, 128)) beside their torch calls
    (``.t().contiguous()``, ``torch.gather``, a bf16 ``torch.matmul``,
    ``index_select``) and ``probes_cuda.noop``, the launch floor of the
    probes' path (a checkout without it reads none), in PROBE_ROUNDS
    rounds, each call with its per-launch breakdown;
  * join_phases: the chained prefixes of the fused co-sort join
    (``join.join_shard_fused`` with keys31, the local join of the shuffle
    join on BM_JoinDpu's keys) at 2Mi rows a side from
    ``make_join_tables(1, 2**21, 2**21)``, the counterpart of
    ``scripts/profile_join_phases.py``: the co-sort of the packed keys and
    the merged payload (``join_sort``: ``join.cosort_k2``), then the whole
    join (``join_full``), whose rest is the fill and match in one kernel
    (``merge.fill_match``), each step folding bit 0 of its output into the
    next step's keys, so the keys stay in range; the difference gives the
    fill and match's ms (``fill_match_delta``). Timed as
    ``bench/device_time.time_chained_multi`` (CUDA-graph chains of JOIN_K
    and 2 JOIN_K steps, (T(2k) - T(k)) / k, the prefixes in turns), with the
    full join's per-launch breakdown; the full join is first held bit for
    bit against the plain path on the CPU.
Each call is captured several times in one graph (CALLS, or BIG_CALLS from
BIG_ROWS rows on), each with outputs of its own, so that no call finds the
last one's outputs in L2; a reading is the median of REPS replays over the
calls, and the readings of a shape are taken ROUNDS times in turns (a, b,
b, a, ...), each the median of its rounds. Before timing, every kernel is
checked against its plain version (or, for the sort, torch.sort).

It calls the wrappers only through ``sort_bitonic(planes)``,
``gather_sorted(data, sidx)``, ``merge_probe(left, right, payloads)``,
``partition_cells(keys, payloads, P, cell, with_sel)``,
``propagate_fill(planes)``, ``propagate_last(alive, planes)``,
``filter_compact(values)``, ``filter_with_indices(values)``, the
alternates' ``filter_compact(values, version)`` and
``filter_with_indices(values, version)``, ``filter_stage(values, stage)``,
``bitonic_merge(planes)``, ``bitonic_merge_blocks(planes, block_rows)``,
``sort_tiles(planes)``, ``sum_u64_pair(values)``, ``block_op(x, idx, op,
reps)``, ``lane_gather(x, idx)``, ``transpose(x)``, ``onehot_matmul(a,
b)`` and ``dyn_row(x, row)`` (and ``noop`` only where the package has
it), and join_phases through ``join_shard_fused`` and its step
``cosort_k2``, so the
same file can time another checkout of the package: run it by its path
with that checkout first on PYTHONPATH, and alternate the two checkouts on
one card. ``--only`` takes a subset of the groups (sort, gather,
merge_probe, partition, fill, filter, merge, tiles, sum, cops,
block_ops, lane_gather, probes, join_phases). It prints one line a reading and,
last, a JSON object of them; ``--out`` writes that object to a file too.
It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import subprocess
import sys

import numpy as np
import torch

from dpu_olap_tpu_torch.bench.device_time import time_chained_multi
from dpu_olap_tpu_torch.ops import (
    bitonic_cuda,
    block_ops_cuda,
    filter_alt_cuda,
    filter_cuda,
    filter_stages,
    join,
    merge,
    merge_cuda,
    partition_cuda,
    probes_cuda,
    scan_cuda,
    sort_cuda,
    sum_cuda,
    take_cuda,
)
from dpu_olap_tpu_torch.ops.hashing import bucket_shift, wang_hash

SEED = 42
SIZES = (1 << 21, 1 << 24)
PROBE_SHAPES = ((1 << 21, 1 << 21), (1 << 20, 1 << 20), (1, 1 << 21))  # (probe, build)
PART_SHAPES = ((1 << 24, 8, True), (1 << 27, 2, False))  # (rows, P, selection)
FILL_N = 1 << 23  # chip_smoke.py FILL_N
FILL_DENSITY = 0.18
ROUND_CELL = 1 << 27  # one side's cell in an SF=64 shuffle round (64 x 2Mi rows)
FILTER_N = 1 << 26  # chip_smoke.py FILTER_N
MERGE_N = 1 << 23  # the sorted-build join's merge length at TPC-H SF=1
TPCH_ORDERS = 1_500_000  # chip_smoke.py TPCH_ORDERS
TILES_N = 1 << 21  # measure_filter's sort section
SUM_N = 1 << 24  # chip_smoke.py SUM_N
COPS_TILES = 128  # measure_filter's cops section: 2Mi int32 in (128, 128) tiles
COPS_REPS = (0, 1, 16)  # 16: the section's ops a call
BLOCK_N = 1 << 21  # the ops and cops sections: 64 (256, 128) blocks, 128 (128, 128) tiles
BLOCK_REPS = (0, 1, 16)
GATHER_SHAPES = ((8192, 128, 128), (32768, 128, 128), (128, 128, 256))  # (rows, W_v, W_i)
EMPTY = 0xFFFFFFFF
CALLS = 10
BLOCK_SETS = CALLS  # inputs of a cold block-op reading: one x and idx a call
GROUPS = ("sort", "gather", "merge_probe", "partition", "fill", "filter", "merge", "tiles", "sum",
          "cops", "block_ops", "lane_gather", "probes", "join_phases")
JOIN_ROWS = 1 << 21  # BM_JoinDpu SF=1, a side (profile_join_phases.py's ROWS)
JOIN_K = 4  # the chains' steps (profile_join_phases.py's K)
BIG_ROWS = 1 << 27
BIG_CALLS = 2
REPS = 7
ROUNDS = 3
# the probes' calls of about 2-5 us: more rounds against their noise; 31,
# since the transposes and their torch call differ by less than the noop's
# own spread between turns
PROBE_ROUNDS = 31
BREAKDOWN_CALLS = 5
PROFILE_TRIES = 3


def replay_ms(fn, calls: int = CALLS) -> float:
    """Median device time of one of fn's calls, ``calls`` of them captured
    in one CUDA graph with their outputs kept, by CUDA events around REPS
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [fn() for _ in range(calls)]
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    del outs, g
    torch.cuda.empty_cache()
    return float(np.median(times)) / calls


def eager_ms(fn) -> float:
    """Median device time of one eager call of fn, by CUDA events around
    each of REPS calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def launch_breakdown(fn, calls: int = BREAKDOWN_CALLS) -> dict:
    """Device ms of one eager call of fn by device event name (kernels,
    memsets and copies): ``calls`` calls under torch.profiler, each event's
    time summed and divided by the calls. A name launched c > 1 times a call
    gets one entry per launch, "name [j/c]", in launch order. A profile
    that saw no device event (the tracer now and then records none) is
    taken again, up to PROFILE_TRIES times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    spans: dict = {}
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.setdefault(e.name, []).append(
                    (e.time_range.start, (e.time_range.end - e.time_range.start) / 1e3))
        if spans:
            break
    if not spans:
        raise SystemExit(f"launch_breakdown: the profiler saw no device events in"
                         f" {PROFILE_TRIES} tries")
    per: dict = {}
    for name, ts in spans.items():
        ts.sort()
        c = len(ts) // calls
        if c <= 1 or len(ts) % calls:
            per[name] = sum(d for _, d in ts) / calls
            continue
        for j in range(c):
            per[f"{name} [{j + 1}/{c}]"] = sum(d for _, d in ts[j::c]) / calls
    return dict(sorted(per.items(), key=lambda kv: -kv[1]))


def _u32(n: int, gen: torch.Generator, high: int | None = None) -> torch.Tensor:
    """n random uint32 values on the card: any word, or below high."""
    if high is None:
        return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda",
                             generator=gen).view(torch.uint32)
    return torch.randint(0, high, (n,), dtype=torch.int64, device="cuda",
                         generator=gen).to(torch.uint32)


def _in_turns(fns: dict, calls: int = CALLS, rounds: int = ROUNDS) -> dict:
    got = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[k].append(replay_ms(fns[k], calls))
    return {k: float(np.median(v)) for k, v in got.items()}


def _same(got, ref) -> bool:
    """Equal bits plane by plane (uint32 planes compared as int32 views)."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.uint32 else t

    return len(got) == len(ref) and all(
        g.shape == r.shape and torch.equal(bits(g), bits(r)) for g, r in zip(got, ref))


def sort_readings(n: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    key, pay = _u32(n, gen), _u32(n, gen)
    got = sort_cuda.sort_bitonic((key, pay))
    if not torch.equal(got[0].to(torch.int64), torch.sort(key.to(torch.int64)).values):
        raise SystemExit(f"sort_bitonic at n={n}: keys not sorted")
    key32 = key.view(torch.int32)
    return _in_turns({"sort": lambda: sort_cuda.sort_bitonic((key, pay)),
                      "torch_sort": lambda: torch.sort(key32)})


def gather_readings(n: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    data = _u32(n, gen)
    sidx = torch.sort(_u32(n, gen, n + n // 64).to(torch.int64)).values.to(torch.uint32)
    if not _same(take_cuda.gather_sorted(data, sidx), take_cuda.gather_sorted_ref(data, sidx)):
        raise SystemExit(f"gather_sorted at n={n}: kernel != plain")
    idx = sidx.to(torch.int64).clamp(max=n - 1).to(torch.int32)
    data32 = data.view(torch.int32)
    return _in_turns({"gather": lambda: take_cuda.gather_sorted(data, sidx),
                      "index_select": lambda: torch.index_select(data32, 0, idx)})


def merge_probe_readings(nl: int, nr: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + nl + nr)
    right = torch.unique(_u32(nr + nr // 8, gen, 2**31).to(torch.int64))[:nr].to(torch.uint32)
    left = torch.sort(_u32(nl, gen, 2**31).view(torch.int32)).values.view(torch.uint32)
    pays = (_u32(right.shape[0], gen),)
    got = merge_cuda.merge_probe(left, right, pays)
    ref = merge_cuda.merge_probe_ref(left, right, pays)
    if not _same((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])):
        raise SystemExit(f"merge_probe at {nl} x {nr}: kernel != plain")
    l32, r32 = left.view(torch.int32), right.view(torch.int32)  # keys < 2^31: same order
    return _in_turns({"merge_probe": lambda: merge_cuda.merge_probe(left, right, pays),
                      "searchsorted": lambda: torch.searchsorted(r32, l32, right=True)})


def partition_readings(n: int, p: int, with_sel: bool) -> tuple:
    gen = torch.Generator(device="cuda").manual_seed(SEED + n + p)
    keys, pays = _u32(n, gen), (_u32(n, gen),)
    cell = n // p * 2 if with_sel else n  # the operators' slack: 2.0, or one side's cell

    def call():
        return partition_cuda.partition_cells(keys, pays, p, cell, with_sel=with_sel)

    got = call()
    ref = partition_cuda.partition_cells_ref(keys, pays, p, cell, with_sel=with_sel)
    planes = [0, 3] + ([2] if with_sel else [])
    if not (_same([got[i] for i in planes] + list(got[1]), [ref[i] for i in planes] + list(ref[1]))
            and bool(got[4]) == bool(ref[4])):
        raise SystemExit(f"partition_cells at n={n} P={p}: kernel != plain")
    del got, ref
    bucket = (wang_hash(keys).to(torch.int64) >> bucket_shift(p)).to(torch.int32)
    calls = BIG_CALLS if n >= BIG_ROWS else CALLS
    ms = _in_turns({"partition": call,
                    "torch_sort_bucket": lambda: torch.sort(bucket, stable=True)}, calls)
    return ms, launch_breakdown(call)


def _breakdown_line(label: str, what: str, parts: dict, card: str) -> None:
    def short(k):  # a kernel's name without its namespace and argument list
        k = k.replace("(anonymous namespace)::", "")
        head = re.match(r"(.*?[\w>])\(", k)
        return head.group(1) + (k[k.rindex(" ["):] if k.endswith("]") else "") if head else k

    print(f"[{label}] {what} per launch, eager, ms: "
          + "; ".join(f"{short(k)} {v:.4f}" for k, v in parts.items()) + f" [{card}]", flush=True)


def fill_readings() -> tuple:
    """propagate_fill (key + 1 payload) and propagate_last (1 plane) at
    FILL_N lanes, live with probability FILL_DENSITY."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + FILL_N)
    alive = torch.rand(FILL_N, generator=gen, device="cuda") < FILL_DENSITY
    key = torch.where(alive, _u32(FILL_N, gen, 2**31).to(torch.int64), EMPTY).to(torch.uint32)
    planes = (key, _u32(FILL_N, gen))
    if not _same(scan_cuda.propagate_fill(planes), scan_cuda.propagate_fill_ref(planes)):
        raise SystemExit(f"propagate_fill at n={FILL_N}: kernel != plain")
    got_h, got = scan_cuda.propagate_last(alive, planes[1:])
    ref_h, ref = scan_cuda.propagate_last_ref(alive, planes[1:])
    if not (torch.equal(got_h, ref_h) and _same(got, ref)):
        raise SystemExit(f"propagate_last at n={FILL_N}: kernel != plain")
    ms = _in_turns({"propagate_fill": lambda: scan_cuda.propagate_fill(planes),
                    "propagate_last": lambda: scan_cuda.propagate_last(alive, planes[1:])})
    return ms, launch_breakdown(lambda: scan_cuda.propagate_fill(planes))


def round_fill_readings() -> tuple:
    """propagate_fill at one SF=64 round: the keys31 co-sort of the round's
    two cells (packed key k2 = key << 1 | side, one payload, half of each
    side's lanes cell padding), sorted by sort_bitonic, then the fill's
    planes as ops/merge.py's _fill_match builds them."""
    n, rows = 2 * ROUND_CELL, ROUND_CELL // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device="cuda")

    pk = torch.arange(rows, device="cuda") * 3
    fk = pk[randint(rows, rows)]
    pads = torch.full((ROUND_CELL - rows,), EMPTY, dtype=torch.int64, device="cuda")
    zeros = torch.zeros_like(pads)
    k2 = torch.cat([pk << 1, pads - 1, (fk << 1) | 1, pads])
    pay = torch.cat([randint(2**32, rows), zeros, randint(2**32, rows), zeros])
    perm = torch.randperm(n, generator=gen, device="cuda")
    planes = tuple(t[perm].to(torch.uint32) for t in (k2, pay))
    del pk, fk, pads, zeros, k2, pay, perm
    k2s, pays = sort_cuda.sort_bitonic(planes)
    del planes
    k2s = k2s.to(torch.int64)
    sk = torch.where(k2s >= EMPTY - 1, EMPTY, k2s >> 1)
    fill = (torch.where((k2s & 1) == 0, sk, EMPTY).to(torch.uint32), pays)
    del k2s, sk
    if not _same(scan_cuda.propagate_fill(fill), scan_cuda.propagate_fill_ref(fill)):
        raise SystemExit(f"propagate_fill at one SF=64 round (n={n}): kernel != plain")
    torch.cuda.empty_cache()

    def call():
        return scan_cuda.propagate_fill(fill)

    return _in_turns({"propagate_fill": call}, BIG_CALLS), launch_breakdown(call)


def _stage_same(stage: str, got, ref) -> bool:
    """A stage's outputs equal its plain version's (lookback on out[:count],
    which the stage leaves unwritten past the count)."""
    got, ref = list(got), list(ref)
    if [g is None for g in got] != [r is None for r in ref]:
        return False
    if stage == "lookback":
        c = int(ref[2])
        got[0], ref[0] = got[0][:c], ref[0][:c]
    return _same([g for g in got if g is not None], [r for r in ref if r is not None])


def filter_readings() -> tuple:
    """filter_compact and filter_with_indices of FILTER_N uniform uint32
    values by v1 and by each alternate (v2, v3, v4), every stage of the
    stage ablation and torch.clone (the copy stage's yardstick), beside the
    predicate + torch.masked_select; per-launch breakdowns of v1, each
    alternate (compact and with indices) and each stage."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + FILTER_N)
    values = _u32(FILTER_N, gen)
    calls = {
        "filter_compact": lambda: filter_cuda.filter_compact(values),
        "filter_with_indices": lambda: filter_cuda.filter_with_indices(values),
    }
    refs = {
        "filter_compact": lambda: filter_cuda.filter_compact_ref(values),
        "filter_with_indices": lambda: filter_cuda.filter_with_indices_ref(values),
    }
    for ver in filter_alt_cuda.VERSIONS:
        calls[f"{ver}_compact"] = lambda ver=ver: filter_alt_cuda.filter_compact(values, ver)
        calls[f"{ver}_with_indices"] = (
            lambda ver=ver: filter_alt_cuda.filter_with_indices(values, ver))
        refs[f"{ver}_compact"] = lambda ver=ver: filter_alt_cuda.filter_compact_ref(values, ver)
        refs[f"{ver}_with_indices"] = (
            lambda ver=ver: filter_alt_cuda.filter_with_indices_ref(values, ver))
    for name, call in calls.items():
        if not _same(call(), refs[name]()):
            raise SystemExit(f"{name} at n={FILTER_N}: kernel != plain")
    for stage in filter_stages.STAGES:
        if not _stage_same(stage, filter_stages.filter_stage(values, stage),
                           filter_stages.filter_stage_ref(values, stage)):
            raise SystemExit(f"filter stage {stage} at n={FILTER_N}: kernel != plain")
        calls[f"stage_{stage}"] = lambda stage=stage: filter_stages.filter_stage(values, stage)
    torch.cuda.synchronize()
    v32 = values.view(torch.int32)
    ms = _in_turns({**calls, "clone": values.clone})
    ms["masked_select_eager"] = eager_ms(
        lambda: torch.masked_select(v32, filter_cuda.below_threshold(values)))
    parts = {name: launch_breakdown(call) for name, call in calls.items()
             if name != "filter_with_indices"}
    parts["clone"] = launch_breakdown(values.clone)
    return ms, parts


def _join_merge_planes(gen: torch.Generator) -> tuple:
    """The sorted-build join's bitonic_merge input at TPC-H SF=1, as
    ops/merge.py's join_shard_sorted_build lays it out: [ascending pk << 1
    | 0xFFFFFFFF pad | descending fk << 1 | 1], one payload plane beside
    it (the orders' x, 0 in the pad, the sorted lineitems' y)."""
    i = torch.arange(TPCH_ORDERS, device="cuda")
    okey = (i // 8) * 32 + i % 8 + 1  # the first 8 of every 32 key values
    per = torch.randint(1, 8, (TPCH_ORDERS,), generator=gen, device="cuda")
    k2_l = torch.sort((torch.repeat_interleave(okey, per) << 1) | 1, descending=True).values
    pad = MERGE_N - TPCH_ORDERS - k2_l.shape[0]
    key = torch.cat([okey << 1, torch.full((pad,), EMPTY, device="cuda"), k2_l])
    pay = torch.cat([_u32(TPCH_ORDERS, gen).to(torch.int64), torch.zeros(pad, device="cuda",
                     dtype=torch.int64), _u32(k2_l.shape[0], gen).to(torch.int64)])
    return key.to(torch.uint32), pay.to(torch.uint32)


def _block_bitonic(n: int, block: int, high: int, gen: torch.Generator) -> torch.Tensor:
    """n keys below high whose every block is an ascending run, then a
    descending one."""
    key = torch.sort(_u32(n, gen, high).to(torch.int64).view(-1, 2, block // 2), dim=2).values
    key[:, 1] = key[:, 1].flip(1)
    return key.reshape(n).to(torch.uint32)


def merge_readings() -> tuple:
    """bitonic_merge at the join's 8Mi call and bitonic_merge_blocks at 8Mi
    in 64Ki blocks, each checked against bitonic_merge_blocks_ref, beside
    torch.sort of the 8Mi key; with the per-launch breakdown of each."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + MERGE_N)
    planes = _join_merge_planes(gen)
    blocks = (_block_bitonic(MERGE_N, 1 << 16, 16, gen), _u32(MERGE_N, gen))
    for got, ref, what in (
            (merge.bitonic_merge(planes),
             bitonic_cuda.bitonic_merge_blocks_ref(planes, MERGE_N // bitonic_cuda.LANES),
             "bitonic_merge"),
            (bitonic_cuda.bitonic_merge_blocks(blocks),
             bitonic_cuda.bitonic_merge_blocks_ref(blocks), "bitonic_merge_blocks")):
        if not _same(got, ref):
            raise SystemExit(f"{what} at n={MERGE_N}: kernel != plain")
    key32 = planes[0].view(torch.int32)
    ms = _in_turns({"bitonic_merge": lambda: merge.bitonic_merge(planes),
                    "merge_blocks_64Ki": lambda: bitonic_cuda.bitonic_merge_blocks(blocks),
                    "torch_sort": lambda: torch.sort(key32)})
    parts = {"bitonic_merge": launch_breakdown(lambda: merge.bitonic_merge(planes)),
             "merge_blocks_64Ki": launch_breakdown(
                 lambda: bitonic_cuda.bitonic_merge_blocks(blocks))}
    return ms, parts


def tiles_readings() -> tuple:
    """sort_tiles at TILES_N + 1 payload (ties in the key), checked against
    sort_tiles_ref, beside torch.sort of the key's tile rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + TILES_N)
    key = _u32(TILES_N, gen, 2**31)
    key[-64:] = key[0]
    planes = (key, _u32(TILES_N, gen))
    got, ref = sort_cuda.sort_tiles(planes), sort_cuda.sort_tiles_ref(planes)
    if not (_same(got[:1], ref[:1])
            and _same(sort_cuda.canonical_tiles(got), sort_cuda.canonical_tiles(ref))):
        raise SystemExit(f"sort_tiles at n={TILES_N}: kernel != plain")
    rows = key.view(torch.int32).view(-1, sort_cuda.TILE)
    ms = _in_turns({"sort_tiles": lambda: sort_cuda.sort_tiles(planes),
                    "torch_sort_rows": lambda: torch.sort(rows, dim=1)})
    return ms, launch_breakdown(lambda: sort_cuda.sort_tiles(planes))


def sum_readings() -> tuple:
    """sum_u64_pair at SUM_N, checked against its plain version, beside
    x.sum(dtype=torch.int64)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + SUM_N)
    values = _u32(SUM_N, gen)
    if not _same(sum_cuda.sum_u64_pair(values), sum_cuda.sum_u64_pair_ref(values)):
        raise SystemExit(f"sum_u64_pair at n={SUM_N}: kernel != plain")
    ms = _in_turns({"sum_u64_pair": lambda: sum_cuda.sum_u64_pair(values),
                    "x_sum_int64": lambda: values.sum(dtype=torch.int64)})
    return ms, launch_breakdown(lambda: sum_cuda.sum_u64_pair(values))


def cops_readings() -> tuple:
    """count_matmul on COPS_TILES tiles at each of COPS_REPS, checked
    against block_op_ref, beside the plain version's torch chain at reps 16
    (bf16 products); the per-launch breakdown at each reps."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + COPS_TILES)
    shape = (COPS_TILES * 128, 128)
    x = torch.randint(-2**14, 2**14, shape, dtype=torch.int32, device="cuda", generator=gen)
    idx = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5, (x >> 7) & 127,
                      torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device="cuda",
                                    generator=gen))
    calls = {f"count_matmul_r{r}": (lambda r=r: block_ops_cuda.block_op(x, idx, "count_matmul", r))
             for r in COPS_REPS}
    for r in COPS_REPS:
        if not torch.equal(calls[f"count_matmul_r{r}"](),
                           block_ops_cuda.block_op_ref(x, idx, "count_matmul", r)):
            raise SystemExit(f"count_matmul at reps {r}: kernel != plain")
    top = COPS_REPS[-1]
    ms = _in_turns({**calls, f"torch_chain_r{top}": lambda: block_ops_cuda.block_op_ref(
        x, idx, "count_matmul", top, matmul_dtype=torch.bfloat16)})
    return ms, {name: launch_breakdown(call) for name, call in calls.items()}


def block_ops_readings() -> tuple:
    """Each block op but count_matmul on BLOCK_N values at each of BLOCK_REPS,
    checked against block_op_ref, beside its L2-cold reading at reps 16
    (BLOCK_SETS inputs in turn) and the plain version's torch chain at reps
    16; the per-launch breakdown of each op at each reps."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    sets = [(torch.randint(-2**31, 2**31, (BLOCK_N // 128, 128), dtype=torch.int32,
                           device="cuda", generator=gen),
             torch.randint(0, 128, (BLOCK_N // 128, 128), dtype=torch.int32, device="cuda",
                           generator=gen)) for _ in range(BLOCK_SETS)]
    x, idx = sets[0]
    ops = [op for op in block_ops_cuda.OPS + block_ops_cuda.COPS if op != "count_matmul"]
    top = BLOCK_REPS[-1]

    def cold(op):  # each call on the next of the sets
        turn = itertools.cycle(sets)
        return lambda: block_ops_cuda.block_op(*next(turn), op, top)

    ms, parts = {}, {}
    for op in ops:
        calls = {f"{op}_r{r}": (lambda op=op, r=r: block_ops_cuda.block_op(x, idx, op, r))
                 for r in BLOCK_REPS}
        for r in BLOCK_REPS:
            if not torch.equal(calls[f"{op}_r{r}"](), block_ops_cuda.block_op_ref(x, idx, op, r)):
                raise SystemExit(f"{op} at reps {r}: kernel != plain")
        ms.update(_in_turns({**calls, f"{op}_cold_r{top}": cold(op),
                             f"{op}_torch_chain_r{top}": (
            lambda op=op: block_ops_cuda.block_op_ref(x, idx, op, top,
                                                      matmul_dtype=torch.bfloat16))}))
        parts.update({name: launch_breakdown(call) for name, call in calls.items()})
    return ms, parts


def lane_gather_readings(rows: int, wv: int, wi: int) -> tuple:
    """lane_gather of (rows, wv) int32 values at (rows, wi) indices in
    [0, wv) (three of them out of range), checked against lane_gather_ref,
    beside torch.gather at the clamped int64 indices."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + rows + wi)
    x = torch.randint(-2**31, 2**31, (rows, wv), dtype=torch.int32, device="cuda", generator=gen)
    i = torch.randint(0, wv, (rows, wi), dtype=torch.int32, device="cuda", generator=gen)
    i[0, :3] = torch.tensor([-1, wv, 2**31 - 1], dtype=torch.int32)
    if not torch.equal(probes_cuda.lane_gather(x, i), probes_cuda.lane_gather_ref(x, i)):
        raise SystemExit(f"lane_gather at ({rows}, {wv}) x {wi}: kernel != plain")
    i64 = i.to(torch.int64).clamp(0, wv - 1)
    ms = _in_turns({"lane_gather": lambda: probes_cuda.lane_gather(x, i),
                    "torch_gather": lambda: torch.gather(x, 1, i64)})
    return ms, launch_breakdown(lambda: probes_cuda.lane_gather(x, i))


def probes_readings() -> tuple:
    """The lowering probes' seven calls (PERF.md row 19), each checked
    against its plain version, beside their torch calls and the noop, each
    with its per-launch breakdown."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)

    def u32(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device="cuda",
                             generator=gen).view(torch.uint32)

    t128, t128i, t512, wx, dx = u32(128, 128), u32(128, 128).view(torch.int32), u32(512, 128), \
        u32(128, 128), u32(512, 128)
    wi = torch.randint(0, 128, (128, 256), dtype=torch.int32, device="cuda", generator=gen)
    wi64 = wi.to(torch.int64)
    a, b = (torch.randint(0, 2, s, device="cuda", generator=gen).to(torch.bfloat16)
            for s in ((128, 128), (128, 256)))
    rows = {r: torch.tensor([r], dtype=torch.int32, device="cuda") for r in (317, -1)}
    pc = probes_cuda
    calls = {  # name: (kernel call, plain call, torch call)
        **{f"transpose_{name}": (lambda t=t: pc.transpose(t), lambda t=t: pc.transpose_ref(t),
                                 lambda t=t: t.t().contiguous())
           for name, t in (("128x128_u32", t128), ("128x128_i32", t128i), ("512x128_u32", t512))},
        "gather_wide": (lambda: pc.lane_gather(wx, wi), lambda: pc.lane_gather_ref(wx, wi),
                        lambda: torch.gather(wx.view(torch.int32), 1, wi64)),
        "onehot": (lambda: pc.onehot_matmul(a, b), lambda: pc.onehot_matmul_ref(a, b),
                   lambda: torch.matmul(a.t(), b)),
        **{f"dyn_row_{r}": (lambda t=t: pc.dyn_row(dx, t), lambda t=t: pc.dyn_row_ref(dx, t),
                            lambda t=t: dx.view(torch.int32).index_select(0, t.clamp(0, 511).long()))
           for r, t in rows.items()},
    }
    for name, (kern, plain, _) in calls.items():
        if not _same([kern()], [plain()]):
            raise SystemExit(f"lowering probe {name}: kernel != plain")
    fns = {name: kern for name, (kern, _, _) in calls.items()}
    fns.update({f"torch_{name}": lib for name, (_, _, lib) in calls.items()})
    if hasattr(pc, "noop"):  # the launch floor
        fns["noop"] = pc.noop
    ms = _in_turns(fns, rounds=PROBE_ROUNDS)
    return ms, {name: launch_breakdown(fn) for name, fn in fns.items()}


def _fold(c, plane):
    """The carry with bit 0 of plane's first rows folded in: fk ^ 1 stays a
    key of the dense build side."""
    return (c.view(torch.int32) ^ (plane[:c.shape[0]].view(torch.int32) & 1)).view(torch.uint32)


JOIN_PREFIXES = {
    "join_sort": lambda c, ly, rk, rx: _fold(c, join.cosort_k2(c, (ly,), rk, (rx,))[0]),
    "join_full": lambda c, ly, rk, rx: _fold(
        c, join.join_shard_fused(c, (ly,), rk, (rx,), keys31=True)[0]),
}


def join_phase_inputs(device: str = "cuda", shrink: int = 1) -> tuple:
    """(fk, y, pk, x) of BM_JoinDpu SF=1 with JOIN_ROWS // shrink rows a
    side, on device."""
    from dpu_olap_tpu_torch.generator import make_join_tables

    left, right = make_join_tables(1, JOIN_ROWS // shrink, JOIN_ROWS // shrink)
    lc, rc = left.concat(), right.concat()
    return tuple(torch.from_numpy(a).to(device) for a in (lc["fk"], lc["y"], rc["pk"], rc["x"]))


def join_phase_readings(device: str = "cuda", shrink: int = 1, reps: int = ROUNDS) -> dict:
    """ms a step of each of JOIN_PREFIXES, chained and in turns, with the
    fill and match's difference; the full join first held bit for bit
    against the plain path on the CPU."""
    lf, ly, rk, rx = join_phase_inputs(device, shrink)
    fk, (y,), (x,), m = join.join_shard_fused(lf, (ly,), rk, (rx,), keys31=True)
    plain = join.join_shard_fused(lf.cpu(), (ly.cpu(),), rk.cpu(), (rx.cpu(),), keys31=True)
    if not (_same([t.cpu() for t in (fk, y, x)], (plain[0], *plain[1], *plain[2]))
            and torch.equal(m.cpu(), plain[3]) and int(m.sum()) == lf.shape[0]):
        raise SystemExit("join_shard_fused: the device's rows != the plain path's")
    ms = {name: sec * 1e3 for name, sec in time_chained_multi(
        [(name, step, lf, JOIN_K, (ly, rk, rx)) for name, step in JOIN_PREFIXES.items()],
        reps=reps).items()}
    ms["fill_match_delta"] = ms["join_full"] - ms["join_sort"]
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name for this run, kept in the JSON")
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=list(GROUPS),
                    help="the groups of readings to take (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_replay needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    out = {"label": args.label, "card": card, "package": sort_cuda.__file__,
           "calls": CALLS, "big_calls": BIG_CALLS, "reps": REPS, "rounds": ROUNDS,
           "probe_rounds": PROBE_ROUNDS,
           "ms": {}, "breakdown": {}}

    def record(size: str, ms: dict) -> None:
        for name, v in ms.items():
            out["ms"][f"{name}_{size}"] = v
            how = "eager" if name.endswith("_eager") else "graph replay"
            print(f"[{args.label}] {name} {size}: {v:.4f} ms a call ({how}) [{card}]", flush=True)

    only = set(args.only)
    for n in SIZES if "sort" in only else ():
        record(f"{n >> 20}Mi", sort_readings(n))
    for n in SIZES if "gather" in only else ():
        record(f"{n >> 20}Mi", gather_readings(n))
    for nl, nr in PROBE_SHAPES if "merge_probe" in only else ():
        size = f"{nl >> 20}Mi" if nl >= 1 << 20 else str(nl)
        record(f"{size}x{nr >> 20}Mi", merge_probe_readings(nl, nr))
    for n, p, with_sel in PART_SHAPES if "partition" in only else ():
        size = f"{n >> 20}Mi_P{p}{'_sel' if with_sel else ''}"
        ms, parts = partition_readings(n, p, with_sel)
        record(size, ms)
        out["breakdown"][size] = parts
        _breakdown_line(args.label, f"partition {size}", parts, card)
    for size, what, readings in ((f"{FILL_N >> 20}Mi", "fill", fill_readings),
                                 (f"{2 * ROUND_CELL >> 20}Mi", "fill", round_fill_readings)):
        if what not in only:
            continue
        ms, parts = readings()
        record(size, ms)
        out["breakdown"][f"{what}_{size}"] = parts
        _breakdown_line(args.label, f"{what} {size}", parts, card)
    for size, group, readings in ((f"{FILTER_N >> 20}Mi", "filter", filter_readings),
                                  (f"{MERGE_N >> 20}Mi", "merge", merge_readings)):
        if group not in only:
            continue
        ms, parts = readings()
        record(size, ms)
        for what, p in parts.items():
            out["breakdown"][f"{what}_{size}"] = p
            _breakdown_line(args.label, f"{what} {size}", p, card)
    for size, what, readings in ((f"{TILES_N >> 20}Mi", "tiles", tiles_readings),
                                 (f"{SUM_N >> 20}Mi", "sum", sum_readings)):
        if what not in only:
            continue
        ms, parts = readings()
        record(size, ms)
        out["breakdown"][f"{what}_{size}"] = parts
        _breakdown_line(args.label, f"{what} {size}", parts, card)
    if "cops" in only:
        size = f"{COPS_TILES}tiles"
        ms, parts = cops_readings()
        record(size, ms)
        for what, p in parts.items():
            out["breakdown"][f"{what}_{size}"] = p
            _breakdown_line(args.label, f"{what} {size}", p, card)
    if "block_ops" in only:
        size = f"{BLOCK_N >> 20}Mi"
        ms, parts = block_ops_readings()
        record(size, ms)
        for what, p in parts.items():
            out["breakdown"][f"{what}_{size}"] = p
            _breakdown_line(args.label, f"{what} {size}", p, card)
    if "probes" in only:
        ms, parts = probes_readings()
        record("lowering", ms)
        for what, p in parts.items():
            out["breakdown"][f"{what}_lowering"] = p
            _breakdown_line(args.label, f"{what} lowering", p, card)
    for rows, wv, wi in GATHER_SHAPES if "lane_gather" in only else ():
        size = f"{rows}x{wi}" + (f"over{wv}" if wi != wv else "")
        ms, parts = lane_gather_readings(rows, wv, wi)
        record(size, ms)
        out["breakdown"][f"lane_gather_{size}"] = parts
        _breakdown_line(args.label, f"lane_gather {size}", parts, card)
    if "join_phases" in only:
        size = f"{JOIN_ROWS >> 20}Mi"
        ms = join_phase_readings()
        record(size, ms)
        print(f"[{args.label}] join_phases {size}: sort {ms['join_sort']:.4f}, fill and match"
              f" {ms['fill_match_delta']:.4f} ms of the full join's {ms['join_full']:.4f}"
              f" (chained differences) [{card}]", flush=True)
        lf, ly, rk, rx = join_phase_inputs()
        parts = launch_breakdown(lambda: join.join_shard_fused(lf, (ly,), rk, (rx,), keys31=True))
        out["breakdown"][f"join_full_{size}"] = parts
        _breakdown_line(args.label, f"join_full {size}", parts, card)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
