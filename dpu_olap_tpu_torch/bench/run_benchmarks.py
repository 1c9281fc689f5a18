"""The operator benchmark suite on the card, as JSON lines (counterpart of
``scripts/run_benchmarks.py``, the Google Benchmark analog).

    python -m dpu_olap_tpu_torch.bench.run_benchmarks [--filter REGEX] [--sf N]
        [--batch-shift N] [--tag TAG] [--join-impl IMPL] [--device cuda|cpu] [--out FILE]
    python scripts/parse_results.py bench_results_torch.json   # JSON -> CSV

Registers the reference's benchmark set (BASELINE.md) under the JAX suite's
entry names, so that each row pairs with a row of ``bench_results.json``:

  filter_tpu / filter_native       SF*128 batches x 2^batch_shift (64Ki)
  sum_tpu / sum_native             SF x 2Mi; *_small: SF*32 x 64Ki
  take_tpu / take_native           SF x 4Mi data, 512Ki indices;
                                   *_small: SF*64 x 64Ki data, 8Ki indices
  hashtable_build_probe, hashtable_probe, hashtable_probe_stream
                                   the sorted store at 1Mi keys (sort and
                                   merge-probe kernels), chained;
  hashtable_cuckoo_build_probe     the cuckoo table, host clock
  partition_tpu, partition_tpu_host  PartitionGpu's two engines, SF*4 x 64Ki
  partition_kernel_p8              the partition kernel, SF*2Mi keys, P = 8
  plan_filter_sum_streaming / _materializing, plan_filter_join_sum_device /
  _host                            the query plan's tiers
  filter_kernel, sum_kernel        SF*8Mi values (filter_kernel only on the
                                   card, as the JAX suite times it only on a TPU)
  take_kernel, take_kernel_stream, take_rowgather_kernel
                                   SF*4Mi data, SF*512Ki indices
  join_kernel                      the sorted-build join at SF*2Mi a side
  parallel_memcpy_t{2,4,8,16}      the host runtime, 2Mi ints
  join_tpu / join_native / join_native_partitioned
                                   SF x 2Mi a side; with ACTIVATE_JOIN_TIMERS=1
                                   and a join route that shuffles
                                   (``--join-impl sort``) the join_tpu row
                                   carries JoinGpu.phase_ms; each Run() then
                                   also runs the timers' chained probes, so
                                   that row's real_ms is not the join's

Operators (``*_tpu``, ``*_native``, the plan, the cuckoo table) are timed on
the host clock around Run(), one warm-up and three timed calls, each ending
in a synchronise of the device of every tensor it returns; the rest are
device timings of chained steps (bench/device_time.py: one CUDA graph of k
and of 2k steps, (T(2k) - T(k)) / k, three reps), each row with
``glue_ms``, its step's elementwise glue timed alone beside it, since
eager torch runs the glue as separate passes where the JAX suite fuses it
into one. Every row carries the median (``real_ms``), ``spread_pct`` =
(max - min) / median of the timed samples, ``backend`` ("cuda" or "cpu")
and ``devices``; the operator rows of filter, sum, take and join get the
matching kernel row's ``device_ms`` and its ``glue_ms`` as
``device_glue_ms``.
Correctness checks raise (never ``assert``): streaming == materializing,
the device-resident plan == the host-bounced one, and no take window
overflow.

Rows go to ``bench_results_torch.json`` at the repository root (a run with
``--filter``: ``bench_results_torch_<tag>.json``), or ``--out``; the JAX
suite's ``bench_results.json`` is never written. It runs on the card;
``--device cpu`` (the kernels' plain versions) and ``run(shrink=...)``
(every length divided by it) exist for the tests.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .harness import bench_result, card_missing, device_set, median, spread_pct, time_samples

REPO = Path(__file__).resolve().parents[2]
CHAIN_REPS = 3

ENTRIES = (
    "filter_tpu", "filter_native",
    "sum_tpu", "sum_native", "sum_tpu_small", "sum_native_small",
    "take_tpu", "take_native", "take_tpu_small", "take_native_small",
    "hashtable_build_probe", "hashtable_probe", "hashtable_probe_stream",
    "hashtable_cuckoo_build_probe",
    "partition_tpu", "partition_tpu_host", "partition_kernel_p8",
    "plan_filter_sum_streaming", "plan_filter_sum_materializing",
    "plan_filter_join_sum_device", "plan_filter_join_sum_host",
    "filter_kernel", "sum_kernel", "take_kernel", "take_kernel_stream",
    "take_rowgather_kernel", "join_kernel",
    "parallel_memcpy_t2", "parallel_memcpy_t4", "parallel_memcpy_t8", "parallel_memcpy_t16",
    "join_tpu", "join_native", "join_native_partitioned",
)
KERNEL_ENTRIES = ("filter_kernel", "sum_kernel", "take_kernel", "take_kernel_stream",
                  "take_rowgather_kernel", "join_kernel")
MEMCPY_THREADS = (2, 4, 8, 16)
# operator row -> the kernel row whose device time it is paired with
DEVICE_PAIRS = {"filter_tpu": "filter_kernel", "sum_tpu": "sum_kernel",
                "take_tpu": "take_kernel", "join_tpu": "join_kernel"}


# ---- workloads (the JAX suite's shapes; ``shrink`` divides every length) ----


def _per_device_batches(sf: int, d: int) -> int:
    return max(d, (sf // d) * d if sf >= d else d)


def filter_table(sf: int, d: int = 1, batch_shift: int = 16, shrink: int = 1):
    """BM_Filter: SF*128 batches (filter_benchmark.cc:150-158)."""
    from ..generator import make_filter_batches

    nb = max(d, (sf * 128 // d) * d)
    return make_filter_batches(nb, max(1, (1 << batch_shift) // shrink))


def sum_table(sf: int, d: int = 1, shrink: int = 1, small: bool = False):
    """BM_Aggr: SF x 2Mi, or the small-batch shape SF*32 x 64Ki
    (aggr_benchmark.cc:146-155)."""
    from ..generator import make_filter_batches

    if small:
        return make_filter_batches(max(d, ((sf * 32) // d) * d), max(1, (1 << 16) // shrink))
    return make_filter_batches(_per_device_batches(sf, d), max(1, (1 << 21) // shrink))


def take_tables(sf: int, d: int = 1, shrink: int = 1, small: bool = False):
    """BM_Take: SF x 4Mi data / 512Ki indices, or SF*64 x 64Ki / 8Ki
    (take_benchmark.cc:155-164)."""
    from ..generator import make_take_batches

    if small:
        return make_take_batches(max(d, ((sf * 64) // d) * d), max(1, (1 << 16) // shrink),
                                 max(1, (1 << 13) // shrink))
    return make_take_batches(_per_device_batches(sf, d), max(1, (1 << 22) // shrink),
                             max(1, (1 << 19) // shrink))


def partition_table(sf: int, d: int = 1, shrink: int = 1):
    """The partition operator's table, SF*4 x 64Ki rows, and its partition
    count, one a batch."""
    from ..generator import make_filter_batches

    nb = _per_device_batches(sf, d) * 4
    return make_filter_batches(nb, max(1, (1 << 16) // shrink)), nb


def join_tables(sf: int, d: int = 1, shrink: int = 1):
    """BM_JoinDpu: SF batches x 2Mi a side (join_benchmark.cc:168-176)."""
    from ..generator import make_join_tables

    nb = _per_device_batches(sf, d)
    per = max(1, max(1 << 10, (sf * (1 << 21)) // nb) // shrink)
    return make_join_tables(nb, per, per)


def hashtable_inputs(shrink: int = 1):
    """The hashtable micro: n unique keys from a seed-42 permutation of 4n
    and random values (hashtable_test.{c,py} analog)."""
    n = max(2, (1 << 20) // shrink)
    rng = np.random.default_rng(42)
    keys = rng.permutation(np.uint32(4 * n))[:n].astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    return keys, vals


# ---- chained steps ---------------------------------------------------------
# Each device row chains one step: the call under test, then its glue, the
# elementwise passes that fold the call's outputs into the next step's
# input. ``*_call(carry, *consts)`` returns the outputs as a flat tuple,
# ``*_glue(carry, *outputs)`` the next carry (the carry's shape and dtype),
# and the suite times the glue alone beside each step (``glue_ms``). The
# glue works in int32, uint32 values as their bit patterns (torch has no
# uint32 bitwise kernels on the card), and folds 0-d outputs together
# before it touches the carry, so it takes as few passes as eager torch
# allows; the JAX suite's glue is one fused pass.


def _i32(t):
    return t.view(torch.int32)


def _bit(t, mask: int = 1):
    """(t & mask) of a 32-bit or bool tensor, as int32."""
    return t.to(torch.int32) if t.dtype == torch.bool else _i32(t) & mask


def _ht_sorted_call(c, vals):
    from ..ops.hashtable import ht_build_sorted, ht_probe_sorted

    return ht_probe_sorted(ht_build_sorted(c, vals), c)


def _ht_probe_call(c, tkeys, tvals):
    from ..ops.hashtable import SortedTable, ht_probe_sorted

    return ht_probe_sorted(SortedTable(tkeys, tvals), c)


def _ht_probe_glue(c, got, found):
    return (_i32(c) ^ _bit(got) ^ _bit(found)).view(torch.uint32)


def _ht_stream_call(c, tkeys, tvals):
    from ..ops.hashtable import SortedTable, ht_probe_sorted_stream

    return ht_probe_sorted_stream(SortedTable(tkeys, tvals), c)


def _ht_stream_glue(c, pos, got, found):
    return (_i32(c) ^ _bit(got) ^ _bit(pos, 2) ^ _bit(found)).view(torch.uint32)


def _partition_call(c, pay, cell):
    from ..ops.partition_cuda import partition_cells

    ck, (cp,), sel, counts, _ = partition_cells(c, (pay,), 8, cell)
    return ck, cp, sel, counts


def _partition_glue(c, ck, cp, sel, counts):
    n = c.shape[0]
    mix = _i32(ck.reshape(-1)[:n]) ^ _i32(cp.reshape(-1)[:n]) ^ _i32(sel.reshape(-1)[:n])
    return (_i32(c) ^ ((mix ^ counts.to(torch.int64).sum().to(torch.int32)) & 1)).view(
        torch.uint32)


def _rehash(v):
    """(v ^ 61 ^ v >> 16) * 0x27D4EB2D mod 2^32 (the JAX suite's rehash) of
    int32 bit patterns, as uint32: the logical shift is the arithmetic one
    masked to 16 bits, and the int32 product wraps as the uint32 one does."""
    return ((v ^ ((v >> 16) & 0xFFFF) ^ 61) * 0x27D4EB2D).view(torch.uint32)


def _filter_call(c):
    from ..ops.filter import filter_compact

    return filter_compact(c)


def _filter_glue(c, out, cnt):
    return _rehash(_i32(out) ^ _i32(cnt))


def _sum_call(c):
    from ..ops.sum_cuda import sum_u64_pair

    return sum_u64_pair(c)


def _sum_glue(c, lo, hi):
    return (_i32(c) ^ (_i32(lo) ^ _i32(hi))).view(torch.uint32)


def _take_call(c, data):
    from ..ops.take_cuda import take_sorted

    return take_sorted(data, c)


def _take_glue(c, out, flag):
    return c ^ flag ^ _bit(out)


def _take_stream_call(c, data):
    from ..ops.take_cuda import take_sorted_stream

    return take_sorted_stream(data, c)


def _take_stream_glue(c, pos, out, flag):
    return c ^ flag ^ _bit(out) ^ _bit(pos, 2)


def _rowgather_call(c, data):
    from ..ops.take import take

    return (take(data, c),)


def _rowgather_glue(c, out):
    return c ^ _bit(out)


def _join_call(c, ly, rk, rx):
    from ..ops.join import join_shard_auto

    fk, (y,), (x,), m = join_shard_auto(c, (ly,), rk, (rx,), keys31=True, pk_sorted=True)
    return fk, y, x, m


def _join_glue(c, fk, y, x, m):
    """Flips bit 0 of each fk by the mix of the outputs (the JAX suite
    carries the mix itself): every key stays in the pk range, so each step
    joins as the first does."""
    per = c.shape[0]
    mix = (_i32(fk[:per]) ^ _i32(y[:per]) ^ _i32(x[:per])) & 1 ^ _bit(m[:per])
    return (_i32(c) ^ mix).view(torch.uint32)


# entry -> (call, glue) of its chained step
STEPS = {
    "hashtable_build_probe": (_ht_sorted_call, _ht_probe_glue),
    "hashtable_probe": (_ht_probe_call, _ht_probe_glue),
    "hashtable_probe_stream": (_ht_stream_call, _ht_stream_glue),
    "partition_kernel_p8": (_partition_call, _partition_glue),
    "filter_kernel": (_filter_call, _filter_glue),
    "sum_kernel": (_sum_call, _sum_glue),
    "take_kernel": (_take_call, _take_glue),
    "take_kernel_stream": (_take_stream_call, _take_stream_glue),
    "take_rowgather_kernel": (_rowgather_call, _rowgather_glue),
    "join_kernel": (_join_call, _join_glue),
}


def step(name: str):
    """The chained step of entry ``name``: its call, then its glue."""
    call, glue = STEPS[name]
    return lambda c, *consts: glue(c, *call(c, *consts))


# ---- the suite --------------------------------------------------------------


def run(pattern: str = ".*", sf: int = 1, batch_shift: int = 16, tag: str | None = None,
        join_impl: str = "cosort", device: str = "cuda", shrink: int = 1) -> list:
    """Run every entry whose name the regex ``pattern`` finds (the JAX
    suite's ``--filter``; a group's inputs are made once for its entries)
    and return its rows; each row is also printed as a JSON line.
    ``device="cuda"`` allocates through DeviceSet.allocate(), which raises
    without a CUDA device."""
    from .. import native
    from ..operators.aggr_op import SumGpu, SumNative
    from ..operators.filter_op import FilterGpu, FilterNative
    from ..operators.join_op import JoinGpu, JoinNative
    from ..operators.take_op import TakeGpu, TakeNative
    from .device_time import CLAMP_S, time_chained_multi

    pat = re.compile(pattern)
    tag = tag or time.strftime("%Y%m%d")
    ds = device_set(device)
    d = ds.nr_devices
    dev = ds.device
    results = []

    def on(name):
        return bool(pat.search(name))

    def record(name, samples, items, extra=None):
        counters = {"tag": tag, "sf": sf, "devices": d, "backend": dev.type,
                    "spread_pct": spread_pct(samples), **(extra or {})}
        r = bench_result(name, samples, items, counters=counters).row()
        results.append(r)
        print(json.dumps(r), flush=True)

    def host(fn):
        """One warm-up and three timed calls on the host clock."""
        return time_samples(fn, warmup=1, iters=3)

    def chained(name, x, k, items, consts=()):
        """Record entry ``name``'s chained step and beside it, interleaved,
        its glue alone on the call's outputs for x (``glue_ms``, the
        median). Per-step seconds of each rep, each at least the
        estimator's clamp (as its median is)."""
        call, glue = STEPS[name]
        spread = {}
        time_chained_multi([("step", step(name), x, k, consts),
                            ("glue", glue, x, k, tuple(call(x, *consts)))],
                           reps=CHAIN_REPS, spread=spread)
        chain, alone = ([max(t, CLAMP_S) for t in spread[c]] for c in ("step", "glue"))
        record(name, chain, items, extra={"glue_ms": median(alone) * 1e3})

    def to_dev(a: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def operator_rows(gpu_name, native_name, make_gpu, make_native, items):
        if on(gpu_name):
            record(gpu_name, host(make_gpu().Prepare().Run), items)
        if on(native_name):
            record(native_name, host(make_native().Prepare().Run), items)

    # filter: SF*128 batches x 64Ki rows
    if on("filter_tpu") or on("filter_native"):
        table = filter_table(sf, d, batch_shift, shrink)
        operator_rows("filter_tpu", "filter_native", lambda: FilterGpu(ds, table),
                      lambda: FilterNative(table), table.num_rows)

    # sum: SF batches x 2Mi, then the small-batch shape
    for suffix, small in (("", False), ("_small", True)):
        if on(f"sum_tpu{suffix}") or on(f"sum_native{suffix}"):
            table = sum_table(sf, d, shrink, small)
            operator_rows(f"sum_tpu{suffix}", f"sum_native{suffix}",
                          lambda t=table: SumGpu(ds, t), lambda t=table: SumNative(t),
                          table.num_rows)

    # take: SF x 4Mi data / 512Ki indices, then the small-batch shape
    for suffix, small in (("", False), ("_small", True)):
        if on(f"take_tpu{suffix}") or on(f"take_native{suffix}"):
            data, idx = take_tables(sf, d, shrink, small)
            operator_rows(f"take_tpu{suffix}", f"take_native{suffix}",
                          lambda a=data, i=idx: TakeGpu(ds, a, i),
                          lambda a=data, i=idx: TakeNative(a, i), idx.num_rows)

    # hashtable micro: the sorted store chained on the card (build and probe
    # take no host readback, so each chain is one CUDA graph); the cuckoo
    # table's build loop reads its convergence back, so it is timed on the
    # host clock, as in the JAX suite
    if any(on(n) for n in ("hashtable_build_probe", "hashtable_probe",
                           "hashtable_probe_stream", "hashtable_cuckoo_build_probe")):
        from ..ops.hashtable import ht_build, ht_build_sorted, ht_probe, table_capacity

        keys, vals = hashtable_inputs(shrink)
        n = keys.shape[0]
        kd, vd = to_dev(keys), to_dev(vals)
        if on("hashtable_build_probe"):
            chained("hashtable_build_probe", kd, 8, n, (vd,))
        if on("hashtable_probe") or on("hashtable_probe_stream"):
            t = ht_build_sorted(kd, vd)
            if on("hashtable_probe"):
                chained("hashtable_probe", kd, 8, n, (t.keys, t.values))
            if on("hashtable_probe_stream"):
                chained("hashtable_probe_stream", kd, 8, n, (t.keys, t.values))
        if on("hashtable_cuckoo_build_probe"):
            cap = table_capacity(n)

            def run_cuckoo():
                _, found = ht_probe(ht_build(kd, vd, cap), kd)
                return found[:1].cpu()

            record("hashtable_cuckoo_build_probe", host(run_cuckoo), n)

    # partition: SF*4 batches x 64Ki, one partition a batch; the resident
    # engine keeps the cells on the device (Run() synchronises), the
    # host-staged one bounces every fragment through host slabs
    if on("partition_tpu") or on("partition_tpu_host"):
        from ..operators import PartitionGpu

        table, nb = partition_table(sf, d, shrink)
        for name, resident in (("partition_tpu", None), ("partition_tpu_host", False)):
            if on(name):
                op = PartitionGpu(ds, table, "a", nb, resident=resident).Prepare()
                record(name, host(op.Run), table.num_rows)

    # the partition kernel alone at P = 8, the cell of the JAX suite
    if on("partition_kernel_p8"):
        n = max(8, sf * (1 << 21) // shrink)
        rng = np.random.default_rng(42)
        keys = to_dev(rng.integers(0, 2**32, n, dtype=np.uint32))
        pay = to_dev(rng.integers(0, 2**32, n, dtype=np.uint32))
        cell = -(-int(n / 8 * 2) // 128) * 128
        chained("partition_kernel_p8", keys, 4, n, (pay, cell))

    # streaming vs materializing plan execution (Filter -> Sum)
    if on("plan_filter_sum_streaming") or on("plan_filter_sum_materializing"):
        from ..generator import make_filter_batches
        from ..plan import Aggregate, Filter, Source

        table = make_filter_batches(max(1, sf) * 16, max(1, (1 << 16) // shrink))

        def run_streaming():
            return Aggregate(Filter(Source(table), "a"), "a").scalar(ds)

        def run_materializing():
            f = Filter(Source(table), "a")
            f._run(ds)  # materialize: the streaming tier no longer applies
            return Aggregate(f, "a").scalar(ds)

        s, m = run_streaming(), run_materializing()
        if s != m:
            raise RuntimeError(f"plan: streaming {s} != materializing {m}")
        for name, fn in (("plan_filter_sum_streaming", run_streaming),
                         ("plan_filter_sum_materializing", run_materializing)):
            if on(name):
                record(name, host(fn), table.num_rows)

    # the device-resident plan chain Filter -> HashJoin -> Aggregate against
    # the same chain bounced through a host Table
    if on("plan_filter_join_sum_device") or on("plan_filter_join_sum_host"):
        from ..generator import make_join_tables
        from ..plan import Aggregate, Filter, HashJoin, Source

        per = max(2, sf * (1 << 20) // shrink)
        left, right = make_join_tables(1, per, per)
        f = Filter(Source(left), "y")
        ftab = f._run(ds)  # cached: device columns
        if not ftab.is_device:
            raise RuntimeError("plan: the materialized Filter left the device")
        host_tab = ftab.to_host()

        def run_device():
            return Aggregate(HashJoin(f, Source(right), fk="fk", pk="pk"), "x").scalar(ds)

        def run_host():
            return Aggregate(HashJoin(Source(host_tab), Source(right), fk="fk", pk="pk"),
                             "x").scalar(ds)

        s_dev, s_host = run_device(), run_host()
        if s_dev != s_host:
            raise RuntimeError(f"plan: device-resident {s_dev} != host {s_host}")
        for name, fn in (("plan_filter_join_sum_device", run_device),
                         ("plan_filter_join_sum_host", run_host)):
            if on(name):
                record(name, host(fn), per)

    # device-resident kernel timings (the reference's nb_cycles counter
    # analog): chained steps on device-resident inputs, no host transfer
    if any(on(n) for n in KERNEL_ENTRIES):
        from ..ops.take_cuda import take_sorted, take_sorted_stream, takeable_sorted

        rng = np.random.default_rng(42)
        n = max(2, sf * (1 << 23) // shrink)  # the reference device buffer: 8Mi items
        if on("filter_kernel") and dev.type == "cuda":
            x = to_dev(rng.integers(0, 2**32, n, dtype=np.uint32))
            chained("filter_kernel", x, 8, n)
        if on("sum_kernel"):
            x = to_dev(rng.integers(0, 2**32, n, dtype=np.uint32))
            # k = 64: at small k the K -> 2K difference of this short op is
            # noise-dominated
            chained("sum_kernel", x, 64, n)

        nd = max(2, sf * (1 << 22) // shrink)
        ni = max(1, sf * (1 << 19) // shrink)

        def take_inputs():
            data = to_dev(rng.integers(0, 2**32, nd, dtype=np.uint32))
            idx = to_dev(rng.integers(0, nd, ni, dtype=np.uint32).astype(np.int32))
            return data, idx

        if on("take_kernel") or on("take_kernel_stream"):
            data, idx = take_inputs()
            if not takeable_sorted(nd, ni):
                raise RuntimeError(f"take_sorted cannot take {ni} queries from {nd} rows")
            if on("take_kernel"):
                if int(take_sorted(data, idx)[1]) != 0:
                    raise RuntimeError("take window overflow at bench shape")
                chained("take_kernel", idx, 8, ni, (data,))
            if on("take_kernel_stream"):
                # order-free: one index sort and the gather, no restore sort
                if int(take_sorted_stream(data, idx)[2]) != 0:
                    raise RuntimeError("take window overflow at bench shape")
                chained("take_kernel_stream", idx, 8, ni, (data,))
        if on("take_rowgather_kernel"):
            data, idx = take_inputs()
            chained("take_rowgather_kernel", idx, 8, ni, (data,))
        if on("join_kernel"):
            from ..generator import make_join_tables

            per = max(2, sf * (1 << 21) // shrink)
            lt, rt = make_join_tables(1, per, per)
            lf, ly = to_dev(lt[0]["fk"]), to_dev(lt[0]["y"])
            rk, rx = to_dev(rt[0]["pk"]), to_dev(rt[0]["x"])
            chained("join_kernel", lf, 4, per, (ly, rk, rx))

    # native-runtime micro suite (memcpy_benchmark.cc analog); a runtime
    # that does not build raises, so the rows run or the suite fails
    if any(on(f"parallel_memcpy_t{t}") for t in MEMCPY_THREADS):
        nbytes = max(16, ((2 << 20) * 4) // shrink)  # 2Mi ints, the reference's largest
        src = np.random.default_rng(0).integers(0, 2**32, nbytes // 4, dtype=np.uint32)
        dst = np.empty_like(src)
        for threads in MEMCPY_THREADS:
            if on(f"parallel_memcpy_t{threads}"):
                record(f"parallel_memcpy_t{threads}",
                       host(lambda t=threads: native.parallel_memcpy(dst, src, nthreads=t)),
                       nbytes // 4)

    # join: SF batches x 2Mi a side
    if on("join_tpu") or on("join_native") or on("join_native_partitioned"):
        left, right = join_tables(sf, d, shrink)
        items = left.num_rows
        if on("join_tpu"):
            op = JoinGpu(ds, left, right, impl=join_impl).Prepare()
            # phase ms columns when ACTIVATE_JOIN_TIMERS=1 (the shuffle
            # route only; the reference's per-phase counters,
            # join_dpu.cc:27-49)
            record("join_tpu", host(op.Run), items, extra=getattr(op, "phase_ms", None))
        if on("join_native"):
            record("join_native", host(JoinNative(left, right).Prepare().Run), items)
        if on("join_native_partitioned"):
            # join_benchmark.cc:159-166 benchmarks Partitioned=true/false
            record("join_native_partitioned",
                   host(JoinNative(left, right, partitioned=True).Prepare().Run), items)

    # pair each operator's wall row with its kernel's chained device rate
    # from the same run (the reference reports nb_cycles beside wall ms)
    by_name = {r["name"]: r for r in results}
    for op_name, kn in DEVICE_PAIRS.items():
        if op_name in by_name and kn in by_name:
            by_name[op_name]["device_ms"] = by_name[kn]["real_ms"]
            by_name[op_name]["device_items_per_s"] = by_name[kn]["items_per_s"]
            by_name[op_name]["device_glue_ms"] = by_name[kn]["glue_ms"]
    return results


def output_path(pattern: str, tag: str) -> Path:
    """bench_results_torch.json for the whole suite, bench_results_torch_<tag>.json
    for a partial run, at the repository root."""
    name = "bench_results_torch.json" if pattern == ".*" else f"bench_results_torch_{tag}.json"
    return REPO / name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filter", default=".*", help="regex of the entries to run")
    ap.add_argument("--sf", type=int, default=1)
    ap.add_argument("--batch-shift", type=int, default=16, help="log2 batch size for filter")
    ap.add_argument("--tag", default=None,
                    help="round tag stamped into every row; partial (--filter) runs write "
                         "bench_results_torch_<tag>.json")
    ap.add_argument("--join-impl", default="cosort", choices=("cosort", "sort", "cuckoo"),
                    help="JoinGpu's impl for join_tpu (sort and cuckoo take the shuffle join)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the kernels' plain versions")
    ap.add_argument("--out", help="write the rows here instead")
    args = ap.parse_args(argv)
    if card_missing(args.device, "run_benchmarks"):
        return 1
    tag = args.tag or time.strftime("%Y%m%d")
    rows = run(args.filter, args.sf, args.batch_shift, tag, args.join_impl, args.device)
    out = Path(args.out) if args.out else output_path(args.filter, tag)
    out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
