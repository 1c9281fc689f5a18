#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (dpu_olap_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from dpu_olap_tpu_torch/csrc and the host runtime
from dpu_olap_tpu_torch/native/runtime.cpp (g++), holds the runtime against
its plain versions (parallel_memcpy of 1 GiB against np.copyto,
parallel_stack of BM_Filter SF=8's batches against np.stack, GB/s beside
each; the host-staged Partitioner's slabs at SF=8 against the resident
engine), runs filter v1 with ENABLE_TRACE=1 in a subprocess (a line a tile,
the counts adding up to the filter's), checks each kernel
against its plain PyTorch version on the card (the radix sort, bit for bit
on every plane, the sorted gather, the radix partition and merge-probe, all
four also timed as graph replays, the partition with its per-launch
breakdown; filter v1 and the forward fill in both modes, also timed as
graph replays and checked on views at offsets 1-3, in two calls in a row
and in CUDA-graph replays; sum, block merge, the filter alternates and
stage ablation, the block ops (every op on 1 to 264 blocks at reps 0 to
17 with indices over the int32 range, misaligned views refused;
count_matmul also on 1 to 264 tiles whose products are not all 0), the
probe primitives (the lane gather also at 1 to 32768 rows by both its
kernels and on misaligned views, the one-hot product at K 16 to 4096 and
every tiling) and the sort's tile stage; the block ops and probes timed
as one call replayed and per call of ten in one graph, the gathers and
the transpose also beside their on-chip floor, printed, the lowering
probes in turns beside the noop kernel's launch floor), the
partition, sort and fill kernels also
at the SF=64 main path's shapes, and times each beside its bound and the
one PyTorch call that computes the same function, then drives each
operator path through Prepare().Run() at the reference benchmark
shapes, each with the kernels' launch counts set to 0 just before its run
and read just after:
  * JoinGpu at BM_JoinDpu SF=64 (128Mi rows a side), above one round's
    budget: the shuffle join in two resident rounds (partition, sort and
    fill kernels), against the dense truth; at SF=8 its _run_ici(rounds=2)
    against pyarrow, impl="sort" at SF=1 against pyarrow, and the
    host-staged partitioned join at SF=8 against the dense truth;
  * PartitionGpu on the SF=8 probe table into 16 partitions, both engines,
    against a numpy oracle;
  * the sorted-store hash table (sort + merge-probe kernels) on the
    hashtable micro's 1Mi keys, against numpy;
  * JoinGpu, the BM_JoinDpu dense-pk join (sort + gather kernels): SF=1
    against pyarrow, SF=8 against the dense truth;
  * JoinGpu's fallbacks at SF=1, each against pyarrow: the sorted-build
    join on TPC-H's sparse o_orderkey shape (sort + merge + fill kernels),
    the fused keys31 join on BM_JoinDpu tables with a permuted build side
    (sort + fill kernels) and the generic fused join on the same tables
    with keys above 2^31 (fill kernel);
  * FilterGpu, BM_Filter (filter kernel): against pyarrow, chunk by chunk;
  * SumGpu, BM_Aggr and its small-batch shape (sum kernel): the exact
    integer against pyarrow;
  * TakeGpu, BM_Take (sort + gather kernels): against pyarrow, batch by
    batch;
  * the filter-kernel measurement entry point
    (python -m dpu_olap_tpu_torch.bench.measure_filter: e2e, parts, v3, v4,
    defaultab, ops, cops, sort), the only path of the filter alternates v2,
    v3, v4, the stage ablation, the in-block primitive ops (block_ops.cu)
    and the sort's tile stage, after those kernels are held bit for bit
    against their plain versions and v1's kernel (phase_filter_alternates,
    phase_filter_stages, phase_block_ops, phase_sort_tiles); no reading may
    lie under its floor;
  * the take/sum/probe/dense measurement entry point
    (python -m dpu_olap_tpu_torch.bench.measure_r3), the only path of the
    lane gather (probes.cu), held against its plain version first
    (phase_probes); no reading may lie under its floor;
  * the lowering-probe entry point
    (python -m dpu_olap_tpu_torch.bench.probe_lowering): every probe of the
    TPU lowering scripts built on the card and equal to numpy;
  * the query plan (dpu_olap_tpu_torch.plan), each chain with its kernels'
    launches counted and a Counters JSON line: Aggregate(Filter(Source))
    on BM_Filter SF=1 and SF=8 through the streaming tier (sum kernel;
    Filter.execute never runs), SF=1 again under metrics.trace (its Chrome
    trace names the scope and CUDA kernels), the materialized Filter at
    SF=1 (filter kernel), on BM_JoinDpu SF=1 the fused filter join (sort +
    fill) and an Aggregate over it (+ sum), the bare join (JoinGpu's dense
    route: sort + gather) and the device-resident Filter -> HashJoin ->
    Aggregate (filter, sort, merge, fill, sum; intermediates on the card),
    Aggregate(TakeNode) on BM_Take SF=1 (sort + gather + sum, no restore
    sort) and Repartition of the SF=8 probe table into 16 partitions
    (partition kernel), against pyarrow or numpy;
  * the operator suite (python -m dpu_olap_tpu_torch.bench.run_benchmarks)
    at SF=1, every entry of the JAX suite, a group at a time, each group
    with the kernels it must launch counted; the join row with
    ACTIVATE_JOIN_TIMERS's flag on the shuffle route (its phase_ms), and
    the SF=64 path's shuffle join at SF=8 with the same timers (partition,
    sort and fill kernels); verify_parity with REFERENCE_SHAPES=1 at SF=1,
    bench_streaming --op filter --sf 1 2 and devicecount, each required to
    return 0;
  * several devices (``[multidevice]``): the paths above over DeviceSets
    of 2 and 4 shards of the card (one controller): JoinGpu at SF=8 beside
    the one-device shuffle join in turns, in 2 rounds, with impl="sort" and
    partitioned, against the dense truth; dist_join_2d on a 2 x 2 mesh
    against the flat join; the exchange with the counts in the cells and
    apart; PartitionGpu, FilterGpu, SumGpu and TakeGpu at SF=8; a plan's
    HashJoin; dryrun_multichip(4) and the weak-scaling curve
    (bench/multichip.py); over the real cards where there are 2 or more.
    Each line gives the exchange's copies and bytes; the partition, sort,
    fill, filter, sum and gather kernels must each launch in the phase;
  * one process a device (``[process_group]``, parallel/process_group.py
    through bench/multiproc.rank_join): BM_JoinDpu SF=8 over an NCCL group
    of the visible cards (this process on one card) in 1 and 2 rounds, and
    one spawn of 4 gloo ranks on the card at world 4, at world 2 (a
    subgroup) and on the 2 x 2 mesh; each rank's padded outputs equal
    (SHA-256) to its shard of the one-controller join, its matched rows
    the dense truth, its collectives counted; the partition, sort and fill
    kernels must launch in the ranks.
For each fallback it also splits the result's readback (copy, numpy mask,
against masking on the card) and profiles one Run() (device busy time, idle
share, the longest device events).
It prints one line per phase, a JSON line with each kernel's numbers, the
card's name and power limit, and last {"ok": true, "device": {...}}. With no
CUDA device, outside the repository, or when any phase fails, it exits
non-zero and prints no "ok" line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 42
SF1_ROWS = 1 << 21  # rows per side of one BM_JoinDpu batch
SF8 = 8
REPS = 7  # timed runs per kernel measurement (median)
RUN_REPS = 3  # timed Run() calls per operator path (median)
FILTER_N = 64 << 20  # one filter round at SF=8 (1024 x 64Ki)
SUM_N = 16 << 20  # one sum round at SF=8 (8 x 2Mi)
FILL_N = 8 << 20  # the sorted-build join's merge length at TPC-H SF=1
TPCH_ORDERS = 1_500_000  # TPC-H SF=1 orders rows (spec §4.2.5)
SF64 = 64  # BM_JoinDpu above one round's budget: 128Mi rows a side
PART_N = 16 << 20  # partition_kernel_p8 at SF=8 (run_benchmarks.py:257-288)
PROBE_N = 2 << 20  # the merge-probe shape merge_pallas.py:49-51 was tuned at
HT_N = 1 << 20  # the hashtable micro (run_benchmarks.py:177-227)
MP_ROUNDS = 9  # interleaved timing rounds of merge-probe against searchsorted
JOIN_PHASES = ("host-prep", "h2d", "join-total", "gather-result")
PART_PHASES = ("partition", "build-probe-take", "gather-result")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BLOCK_N = 2 << 20  # the ops and cops probes: 64 (256, 128) blocks, 128 (128, 128) tiles
OP_REPS = 16  # chained ops in one ops/cops call (scripts/measure_filter.py)
EDGE_I32 = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1, 127, 128, 2**30,
                     2**30 + 1, -129], np.int32)  # the wrapping adds and the clip run on these


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn) -> float:
    """Median device time of fn over REPS runs, by CUDA events."""
    import torch

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


def on_card(a: np.ndarray):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")


def host(t) -> np.ndarray:
    return t.cpu().numpy()


def canon(cols) -> np.ndarray:
    rows = np.stack([np.asarray(c) for c in cols])
    return rows[:, np.lexsort(rows[::-1])]


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move nbytes through HBM."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def library_ms(label: str, fn):
    """cuda_ms of one PyTorch call that computes a kernel's function (a
    yardstick; the port never calls it), or None where CUDA does not take
    the call."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        print(f"[library] {label}: no time, the call raised: {e}", flush=True)
        return None
    return cuda_ms(fn)


def kernel_row(err, ms, plain_ms, nbytes, lib_ms) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes", "library_ms": lib_ms}


def rand_u32(n: int, gen):
    """n random uint32 values made on the card from the generator."""
    import torch

    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda",
                         generator=gen).view(torch.uint32)


def card_equal(got, ref) -> bool:
    """Every pair of equal-shape tensors holds the same bits (compared on the
    card: these are too large to copy back). 4-byte planes are compared as
    int32 (torch has no uint32 compare), others (has masks) as they are."""
    import torch

    def bits(t):
        return t.view(torch.int32) if t.element_size() == 4 else t

    return len(got) == len(ref) and all(
        g.shape == r.shape and torch.equal(bits(g), bits(r))
        for g, r in zip(got, ref))


def max_err(got, ref) -> int:
    """Largest absolute difference of two integer arrays (0 when equal)."""
    g, r = np.asarray(got).astype(np.int64), np.asarray(ref).astype(np.int64)
    return int(np.abs(g - r).max()) if g.size else 0


def phase_build() -> None:
    from dpu_olap_tpu_torch import native
    from dpu_olap_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.library()
    built = _kernels.build_seconds
    print(
        f"[build] {so.name}: nvcc {'%.2f s' % built if built is not None else 'cached'}, "
        f"ready in {time.perf_counter() - t0:.2f} s",
        flush=True,
    )
    cached = native.library_path().exists()
    t0 = time.perf_counter()
    rt = native.build()
    native.library()
    print(f"[build] {rt.name}: g++ {'cached' if cached else '%.2f s' % (time.perf_counter() - t0)}",
          flush=True)


def phase_glue(rng) -> None:
    """The uint32 glue ops of the plain paths, on the card, against numpy."""
    import torch

    from dpu_olap_tpu_torch.ops import aggregate, filter as filt, filter_cuda, merge, take

    dev = torch.device("cuda", 0)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    a[:6] = [0, 2**31, 0xFFFFFFFE, 0xFFFFFFFF, (1 << 30) - 1, 1 << 30]
    ta = on_card(a)
    require(ta.dtype == torch.uint32 and np.array_equal(host(ta), a), "uint32 H2D/D2H round trip")
    a64 = ta.to(torch.int64)
    require(np.array_equal(host(a64), a.astype(np.int64)), "uint32 -> int64")
    lo = 123456789
    wrapped = merge._u32(a64 - lo)
    require(np.array_equal(host(wrapped), a - np.uint32(lo)), "wrapping u32 subtraction")
    mask = a64 < 2**31
    require(np.array_equal(host(mask), a < 2**31), "int64 compare above 2^31")
    require(
        np.array_equal(host(merge._where0(mask, ta)), np.where(a < 2**31, a, 0)),
        "uint32 where via int32 view",
    )
    order = torch.sort(a64, stable=True).indices
    require(
        np.array_equal(host(ta.view(torch.int32)[order].view(torch.uint32)), np.sort(a)),
        "int64 sort + int32-view index",
    )
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    flag |= torch.zeros((), dtype=torch.int32, device=dev)
    require(flag.item() == 0, "int32 flag or-reduce")
    # filter: the threshold predicate through the int32 view, per-row counts
    keep = filt.default_predicate(ta)
    require(np.array_equal(host(keep), a < (1 << 30)), "threshold predicate via int32 view")
    require(
        np.array_equal(host(keep.reshape(4, -1).sum(dim=1)), (a < (1 << 30)).reshape(4, -1).sum(1)),
        "per-row bool counts",
    )
    # plain compaction: bool cumsum, int64 where, int32 scatter, int64 -> uint32
    out, sel, cnt = filter_cuda.compact_scatter(ta, keep, 0, with_indices=True)
    c = int((a < (1 << 30)).sum())
    require(int(cnt) == c, "plain compaction count")
    require(np.array_equal(host(out)[:c], a[a < (1 << 30)]), "plain compaction values")
    require(np.array_equal(host(sel)[:c], np.flatnonzero(a < (1 << 30))), "plain compaction rows")
    # take: unsigned clip in int64, arange -> uint32, uint32 fill and cat
    n = 1000
    clip = take._clip_u32(ta, n)
    require(np.array_equal(host(clip), np.minimum(a, n - 1)), "unsigned clip via int64")
    pos = torch.arange(300, device=dev).to(torch.uint32)
    pad = torch.full((5,), 0xFFFFFFFF, dtype=torch.uint32, device=dev)
    both = host(torch.cat([pos, pad]))
    require(
        np.array_equal(both, np.concatenate([np.arange(300), np.full(5, 0xFFFFFFFF)]).astype(np.uint32)),
        "arange -> uint32, uint32 fill and cat",
    )
    # aggregate: int64 halves and shifts, 0-d uint32 readback, min/max, f32 partials
    lo32, hi32 = aggregate.sum_cuda.sum_u64_pair_ref(ta)
    require(aggregate.u64_pair_to_int(lo32, hi32) == int(a.astype(np.uint64).sum()), "plain u64 sum")
    require(int(aggregate.min_u32(ta)) == int(a.min()), "min via int64")
    require(int(aggregate.max_u32(ta)) == int(a.max()), "max via int64")
    f = rng.random(5000, dtype=np.float32)
    parts = host(aggregate.sum_f64_partials(on_card(f)))
    require(np.allclose(parts.sum(), f.astype(np.float64).sum(), rtol=1e-5), "f32 block partials")
    print("[glue] uint32 glue ops on the card agree with numpy", flush=True)


def phase_join_entry_points(rng) -> None:
    """The join entry points off JoinGpu's path (join_shard with the
    cosort, sort and cuckoo probes; the fused join with valid masks) on
    the card, against the same calls on the CPU."""
    import torch

    from dpu_olap_tpu_torch.ops import join

    n_r, n_l = 1 << 16, 1 << 17
    pk = rng.permutation(np.arange(2 * n_r, dtype=np.uint32))[:n_r]
    fk = pk[rng.integers(0, n_r, n_l)]
    fk[: n_l // 16] += np.uint32(2 * n_r)  # misses
    x = rng.integers(0, 2**32, n_r, dtype=np.uint32)
    x16 = rng.integers(0, 2**16, n_r, dtype=np.uint16)
    y = rng.integers(0, 2**32, n_l, dtype=np.uint32)
    lv, rv = rng.random(n_l) < 0.9, rng.random(n_r) < 0.9
    cpu = [torch.from_numpy(a) for a in (fk, y, pk, x, x16, lv, rv)]
    dev = [t.to("cuda") for t in cpu]

    def run(t, impl):
        return join.join_shard(t[0], (t[1],), t[2], (t[3], t[4]), left_valid=t[5],
                               right_valid=t[6], impl=impl)

    for impl in ("cosort", "sort", "cuckoo"):
        got, ref = run(dev, impl), run(cpu, impl)
        require(np.array_equal(host(got[3]), ref[3].numpy()), f"join_shard {impl}: found")
        require(all(np.array_equal(host(g), r.numpy()) for g, r in zip(got[2], ref[2])),
                f"join_shard {impl}: right columns")
    for keys31 in (False, True):
        got = join.join_shard_fused(dev[0], (dev[1],), dev[2], (dev[3],), left_valid=dev[5],
                                    right_valid=dev[6], keys31=keys31)
        ref = join.join_shard_fused(cpu[0], (cpu[1],), cpu[2], (cpu[3],), left_valid=cpu[5],
                                    right_valid=cpu[6], keys31=keys31)
        g = [host(got[0]), host(got[1][0]), host(got[2][0])]
        r = [ref[0].numpy(), ref[1][0].numpy(), ref[2][0].numpy()]
        require(np.array_equal(g[0], r[0]) and np.array_equal(host(got[3]), ref[3].numpy()),
                f"join_shard_fused keys31={keys31}: keys or matched")
        require(np.array_equal(canon(g), canon(r)), f"join_shard_fused keys31={keys31}: rows")
    torch.cuda.synchronize()
    print(f"[join entry points] join_shard (cosort, sort, cuckoo) and join_shard_fused with"
          f" valid masks, {n_l} x {n_r} rows: card == CPU", flush=True)


GRAPH_CALLS = 10  # calls captured in one graph for a replay reading of a short kernel
PROBE_ROUNDS = 9  # rounds in turns of the lowering probes' calls of 10, a few us each


def interleaved(fns: dict, rounds: int = 3) -> dict:
    """Median of each reading over rounds taken in turns (a, b, ..., b, a,
    ...), so that drift on the card falls on every reading alike."""
    got = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[k].append(fns[k]())
    return {k: float(np.median(v)) for k, v in got.items()}


def phase_sort_gather(rng, card: str) -> dict:
    """The radix sort and the sorted gather against their plain versions,
    bit for bit on every plane, on the card; timed eager and as graph
    replays beside the PyTorch call that computes the same function."""
    import torch

    from dpu_olap_tpu_torch.ops import sort_cuda, take_cuda

    def dup_keys(n):
        key = rng.integers(0, 0xFFFFFFFF, n, dtype=np.uint32)
        pool = rng.integers(0, 0xFFFFFFFF, 1000, dtype=np.uint32)
        dup = rng.choice(n, n // 4, replace=False)
        key[dup] = pool[rng.integers(0, len(pool), len(dup))]  # many duplicates
        return key

    def max_keys(n):
        key = dup_keys(n)
        key[rng.choice(n, n // 3, replace=False)] = 0xFFFFFFFF
        return key

    n_odd = 3 * (1 << 20) + 17
    cases = [  # (label, keys, payloads: None = random, or given planes)
        ("random", dup_keys(SF1_ROWS), 1), ("random", dup_keys(SF1_ROWS), 3),
        ("random", dup_keys(n_odd), 1), ("random", dup_keys(n_odd), 3),
        ("random", dup_keys(2), 2), ("random", dup_keys(1000), 2),
        ("random", dup_keys(5000), 2),
        ("0xFFFFFFFF keys, distinct payloads", max_keys(5000),
         [rng.permutation(5000).astype(np.uint32)]),
        ("0xFFFFFFFF keys, distinct payloads", max_keys(n_odd),
         [np.arange(n_odd, dtype=np.uint32)]),
        ("all keys equal", np.full(n_odd, 77, np.uint32), 1),
        ("low 8 bits only", rng.integers(0, 256, n_odd, dtype=np.uint32), 2),
        ("high 8 bits only", rng.integers(0, 256, n_odd, dtype=np.uint32) << np.uint32(24), 2),
        ("random", dup_keys(SF1_ROWS), 0), ("random", dup_keys((1 << 20) + 7), 8),
    ]
    sort_err = 0
    for label, key, pays in cases:
        n = len(key)
        if not isinstance(pays, list):
            pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(pays)]
        planes = tuple(on_card(p) for p in (key, *pays))
        ref = sort_cuda.sort_bitonic_ref(planes)
        got = sort_cuda.sort_bitonic(planes)
        require(card_equal(got, ref), f"sort {label} n={n} payloads={len(pays)}: kernel != plain")
        g = [host(t) for t in got]
        require(np.array_equal(g[0], np.sort(key)), f"sort {label} n={n}: keys not sorted")
        require(np.array_equal(canon(g), canon([key, *pays])), f"sort {label} n={n}: rows differ")
        sort_err = max(sort_err, card_err(got, ref))
        print(f"[sort] {label} n={n} payloads={len(pays)}: kernel == plain on every plane",
              flush=True)

    # the join's shape: (idx, y) at 2Mi, full-range keys
    timed = tuple(on_card(p) for p in (dup_keys(SF1_ROWS),
                                       rng.integers(0, 2**32, SF1_ROWS, dtype=np.uint32)))
    key32 = timed[0].view(torch.int32)
    # torch.sort of the key alone (its int32 view: the same 4-byte radix
    # sort) is a lower bound: no one call sorts payloads along
    s_eager = interleaved({"kernel": lambda: cuda_ms(lambda: sort_cuda.sort_bitonic(timed)),
                           "lib": lambda: cuda_ms(lambda: torch.sort(key32))})
    s_graph = interleaved({"kernel": lambda: graph_ms(lambda: sort_cuda.sort_bitonic(timed)),
                           "lib": lambda: graph_ms(lambda: torch.sort(key32))})
    s_plain = cuda_ms(lambda: sort_cuda.sort_bitonic_ref(timed))
    s_plain_graph = graph_ms(lambda: sort_cuda.sort_bitonic_ref(timed))
    sort_bytes = 2 * 2 * 4 * SF1_ROWS  # key + payload, read and written
    print(
        f"[sort] n={SF1_ROWS} 1 payload: kernel {s_eager['kernel']:.4f} ms eager,"
        f" {s_graph['kernel']:.4f} graph; torch.sort of the key {s_eager['lib']:.4f} eager,"
        f" {s_graph['lib']:.4f} graph; plain {s_plain:.4f} eager, {s_plain_graph:.4f} graph;"
        f" bound {bound_ms(sort_bytes):.4f} ms (median of {REPS}, CUDA events, 3 rounds in turns)"
        f" [{card}]",
        flush=True,
    )

    def gather_case(label, data, sidx):
        got = take_cuda.gather_sorted(data, sidx)
        ref = take_cuda.gather_sorted_ref(data, sidx)
        require(card_equal(got, ref), f"gather {label}: kernel != plain")
        s, d = host(sidx), host(data)
        expect = np.where(s < len(d), d[np.minimum(s, len(d) - 1)], 0).astype(np.uint32)
        require(np.array_equal(host(ref[0]), expect), f"plain gather {label}")
        return card_err(got, ref)

    gather_err = 0
    tables = {}
    for n in (SF1_ROWS, SF8 * SF1_ROWS):  # the join's shapes at SF=1 and SF=8
        data = rng.integers(0, 2**32, n, dtype=np.uint32)
        sidx = np.sort(rng.integers(0, n + n // 64, n).astype(np.uint32))  # tail out of range
        tables[n] = (on_card(data), on_card(sidx))
        gather_err = max(gather_err, gather_case(f"{n} sorted queries", *tables[n]))
    data, sidx = tables[SF1_ROWS]
    for off in (1, 2, 3):  # a slice of sidx: not 16-byte aligned
        gather_err = max(gather_err, gather_case(f"sidx[{off}:]", data, sidx[off:]))
    for k in (1, 2, 3, 5):
        gather_err = max(gather_err, gather_case(f"k={k}", data, sidx[:k]))
        gather_err = max(gather_err, gather_case(f"k={k} at offset 1", data, sidx[1:1 + k]))
    tail = sidx.clone()
    tail[-(SF1_ROWS // 10):] = 0xFFFFFFFF  # an all-out-of-range tail
    gather_err = max(gather_err, gather_case("out-of-range tail", data, tail))
    print(f"[gather] kernel == plain: {SF1_ROWS} and {SF8 * SF1_ROWS} queries, sidx at offsets"
          f" 1-3, k = 1, 2, 3, 5, an out-of-range tail", flush=True)

    rows = {}
    for n, (data, sidx) in tables.items():
        # index_select needs in-range indices: the out-of-range tail clipped
        idx = sidx.to(torch.int64).clamp(max=n - 1).to(torch.int32)
        data32 = data.view(torch.int32)
        eager = interleaved({"kernel": lambda: cuda_ms(lambda: take_cuda.gather_sorted(data, sidx)),
                             "lib": lambda: cuda_ms(lambda: torch.index_select(data32, 0, idx))})
        graph = interleaved({
            "kernel": lambda: graph10_ms(lambda: take_cuda.gather_sorted(data, sidx)),
            "lib": lambda: graph10_ms(lambda: torch.index_select(data32, 0, idx))})
        plain_ms = cuda_ms(lambda: take_cuda.gather_sorted_ref(data, sidx))
        plain_graph = graph_ms(lambda: take_cuda.gather_sorted_ref(data, sidx))
        nbytes = 3 * 4 * n  # table and positions read, values written
        print(
            f"[gather] {n} sorted queries into {n} rows: kernel {eager['kernel']:.4f} ms eager,"
            f" {graph['kernel']:.4f} graph; torch.index_select {eager['lib']:.4f} eager,"
            f" {graph['lib']:.4f} graph; plain {plain_ms:.4f} eager, {plain_graph:.4f} graph;"
            f" bound {bound_ms(nbytes):.4f} ms (graph: {GRAPH_CALLS} calls a replay; 3 rounds in"
            f" turns) [{card}]",
            flush=True,
        )
        rows[n] = (eager, graph, plain_ms, plain_graph, nbytes)
    eager, graph, plain_ms, plain_graph, nbytes = rows[SF1_ROWS]
    return {
        "sort_bitonic": {
            **kernel_row(sort_err, s_eager["kernel"], s_plain, sort_bytes, s_eager["lib"]),
            "graph_ms": s_graph["kernel"], "plain_graph_ms": s_plain_graph,
            "library_graph_ms": s_graph["lib"],
        },
        "gather_sorted": {
            **kernel_row(gather_err, eager["kernel"], plain_ms, nbytes, eager["lib"]),
            "graph_ms": graph["kernel"], "plain_graph_ms": plain_graph,
            "library_graph_ms": graph["lib"],
        },
    }


def _filter_inputs(rng):
    """(name, values) cases for the filter kernel check."""
    t = 1 << 30
    cases = [("random 64Mi", rng.integers(0, 2**32, FILTER_N, dtype=np.uint32))]
    odd = 3 * (1 << 20) + 17
    cases.append((f"random {odd}", rng.integers(0, 2**32, odd, dtype=np.uint32)))
    for n in (1, 127, 4095, 4096, 4097):  # around the kernel's tile of 4096
        cases.append((f"random {n}", rng.integers(0, 2**32, n, dtype=np.uint32)))
    i = np.arange(odd)
    cases.append(("all pass", rng.integers(0, t, odd, dtype=np.uint32)))
    cases.append(("none pass", rng.integers(t, 2**32, odd, dtype=np.uint32)))
    last = rng.integers(t, 2**32, odd, dtype=np.uint32)
    last[-1] = 5  # one kept value, in the last tile
    cases.append(("one kept in the last tile", last))
    cases.append(("alternating", np.where(i % 2 == 0, 7, 0xC0000000).astype(np.uint32)))
    edges = np.array([0, t - 1, t, 0xFFFFFFFF], dtype=np.uint32)
    cases.append(("boundary values", edges[rng.integers(0, 4, odd)]))
    return cases


def phase_filter_kernel(rng, card: str) -> dict:
    """Filter kernel == plain, bit for bit, on the card; timed at 64Mi."""
    import torch

    from dpu_olap_tpu_torch.ops import filter_cuda

    err = 0
    timed = views = None
    for name, v in _filter_inputs(rng):
        tv = on_card(v)
        keep = v < (1 << 30)
        c = int(keep.sum())
        for fill in (0, 0xDEADBEEF):
            got, gc = filter_cuda.filter_compact(tv, fill)
            ref, rc = filter_cuda.filter_compact_ref(tv, fill)
            got, ref = host(got), host(ref)
            require(int(rc) == c and np.array_equal(ref[:c], v[keep]), f"plain filter {name}")
            require(np.all(ref[c:] == np.uint32(fill)), f"plain filter tail {name}")
            require(int(gc) == c and np.array_equal(got, ref), f"filter kernel != plain: {name} fill={fill:#x}")
            err = max(err, max_err(got, ref))
        gv, gs, gc = filter_cuda.filter_with_indices(tv)
        rv, rs, rc = filter_cuda.filter_with_indices_ref(tv)
        require(np.array_equal(host(rs)[:c], np.flatnonzero(keep)), f"plain filter rows {name}")
        require(np.all(host(rs)[c:] == len(v)), f"plain filter row tail {name}")
        require(
            int(gc) == int(rc) == c and np.array_equal(host(gv), host(rv))
            and np.array_equal(host(gs), host(rs)),
            f"filter_with_indices kernel != plain: {name}",
        )
        err = max(err, max_err(host(gs), host(rs)))
        print(f"[filter] {name} (n={len(v)}, kept {c}): kernel == plain", flush=True)
        if len(v) == FILTER_N:
            timed = tv
        elif views is None and name.startswith("random"):
            views = tv  # 3Mi + 17 random values: the views and replays below

    def both(x):
        return (*filter_cuda.filter_compact(x, 0xDEADBEEF), *filter_cuda.filter_with_indices(x))

    def both_ref(x):
        return (*filter_cuda.filter_compact_ref(x, 0xDEADBEEF),
                *filter_cuda.filter_with_indices_ref(x))

    for off in (1, 2, 3):  # views that are not 16-byte aligned
        require(card_equal(both(views[off:]), both_ref(views[off:])),
                f"filter kernel != plain on a view at offset {off}")
    first = both(views)
    require(card_equal(first, both(views)) and card_equal(first, both_ref(views)),
            "filter kernel: two calls in a row differ, or differ from plain")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both(views)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = both(views)
    for r in range(2):  # each replay clears and reuses the work memory
        views.copy_(rand_u32(views.shape[0], torch.Generator(device="cuda").manual_seed(SEED + r)))
        graph.replay()
        require(card_equal(captured, both_ref(views)), f"filter kernel != plain in graph replay {r}")
    del graph, captured, first
    print("[filter] kernel == plain on views at offsets 1-3, in two calls in a row and in two"
          " CUDA-graph replays", flush=True)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: filter_cuda.filter_compact(timed))
    plain_ms = cuda_ms(lambda: filter_cuda.filter_compact_ref(timed))
    idx_ms = cuda_ms(lambda: filter_cuda.filter_with_indices(timed))
    idx_plain_ms = cuda_ms(lambda: filter_cuda.filter_with_indices_ref(timed))
    replay_ms = graph10_ms(lambda: filter_cuda.filter_compact(timed))
    replay_idx_ms = graph10_ms(lambda: filter_cuda.filter_with_indices(timed))
    t32 = timed.view(torch.int32)
    lib = library_ms("torch.masked_select",
                     lambda: torch.masked_select(t32, filter_cuda.below_threshold(timed)))
    nbytes = 2 * 4 * FILTER_N  # values read, padded values written
    print(
        f"[filter] n={FILTER_N}: filter_compact kernel {ms:.4f} ms eager,"
        f" {replay_ms:.4f} graph, plain {plain_ms:.4f} ms,"
        f" predicate + torch.masked_select {lib} ms, bound {bound_ms(nbytes):.4f} ms;"
        f" filter_with_indices kernel {idx_ms:.4f} ms eager,"
        f" {replay_idx_ms:.4f} graph, plain {idx_plain_ms:.4f} ms, bound"
        f" {bound_ms(12 * FILTER_N):.4f} ms (median of {REPS}, CUDA events; graph:"
        f" {GRAPH_CALLS} calls a replay) [{card}]",
        flush=True,
    )
    return {**kernel_row(err, ms, plain_ms, nbytes, lib), "graph_ms": replay_ms,
            "indices_ms": idx_ms, "indices_graph_ms": replay_idx_ms,
            "indices_bound_ms": bound_ms(12 * FILTER_N)}


ALTERNATES = (("v2", "filter2.cu", "dpu_olap_tpu/ops/filter_pallas2.py:220"),
              ("v3", "filter3.cu", "dpu_olap_tpu/ops/filter_pallas3.py:215"),
              ("v4", "filter4.cu", "dpu_olap_tpu/ops/filter_pallas4.py:200"))
MF_N = 8 << 20  # measure_filter's smaller size: every section times the kernels there


def card_err(got, ref) -> int:
    """Largest absolute difference of equal-shape uint32 tensors, on the card."""
    import torch

    err = 0
    for g, r in zip(got, ref):
        if g.numel():
            err = max(err, int((g.to(torch.int64) - r.to(torch.int64)).abs().max()))
    return err


def phase_filter_alternates(rng, card: str) -> dict:
    """The filter alternates v2, v3 and v4 bit for bit on the card against
    their plain versions, whole arrays with their tails, with and without
    indices, and against v1's kernel where v1 computes the same function
    (threshold 2^30): 64Mi and 8Mi random (measure_filter's two sizes),
    3·2^20+17, 1, 4095-4097 (around the tile), views at offsets 1-3, all
    pass, none pass, one kept value at the end; thresholds 2^30, 0, 2^31
    and 0xFFFFFFFF; the _padded wrappers with fill 7. Timed
    at 64Mi, eager and as graph replays, beside the bound, the plain
    version and predicate + masked_select."""
    import torch

    from dpu_olap_tpu_torch.ops import filter_alt_cuda as alt
    from dpu_olap_tpu_torch.ops import filter_cuda

    t = filter_cuda.THRESHOLD
    odd = 3 * (1 << 20) + 17
    one_end = np.full(odd, 0xC0000000, np.uint32)
    one_end[-1] = 5
    cases = [
        ("random 64Mi", rng.integers(0, 2**32, FILTER_N, dtype=np.uint32), (t, 1 << 31)),
        ("random 8Mi", rng.integers(0, 2**32, MF_N, dtype=np.uint32), (t, 1 << 31)),
        (f"random {odd}", rng.integers(0, 2**32, odd, dtype=np.uint32),
         (t, 0, 1 << 31, 0xFFFFFFFF)),
        ("random 1", rng.integers(0, 2**32, 1, dtype=np.uint32), (t, 0, 1 << 31, 0xFFFFFFFF)),
        ("all pass", rng.integers(0, t, odd, dtype=np.uint32), (t,)),
        ("none pass", rng.integers(t, 2**32, odd, dtype=np.uint32), (t,)),
        ("one kept value at the end", one_end, (t,)),
        *((f"random {n}", rng.integers(0, 2**32, n, dtype=np.uint32),
           (t, 0, 1 << 31, 0xFFFFFFFF))
          for n in (4095, 4096, 4097)),  # around the one-sweep kernels' tile
    ]
    errs = dict.fromkeys(alt.VERSIONS, 0)
    timed = None
    for name, v, thresholds in cases:
        tv = on_card(v)
        n = len(v)
        if n == FILTER_N:
            timed = tv
        v1 = filter_cuda.filter_compact(tv, 7), filter_cuda.filter_with_indices(tv)
        for thr in thresholds:
            keep = v < thr
            c = int(keep.sum())
            for ver in alt.VERSIONS:
                got = alt.filter_compact(tv, ver, thr, 7), alt.filter_with_indices(tv, ver, thr)
                ref = (alt.filter_compact_ref(tv, ver, thr, 7),
                       alt.filter_with_indices_ref(tv, ver, thr))
                require(all(card_equal(g, r) for g, r in zip(got, ref)),
                        f"filter {ver} kernel != plain: {name} threshold {thr:#x}")
                require(int(got[0][1]) == c, f"filter {ver} count != numpy: {name} threshold {thr:#x}")
                if thr == t:
                    require(card_equal(got[1], v1[1]), f"filter {ver} with indices != v1: {name}")
                    if ver != "v2":  # v2 has no _padded wrapper, as in the JAX package
                        got = (*got, alt.filter_padded(tv, ver, 7))
                        require(card_equal(got[2], v1[0]), f"filter {ver} padded != v1: {name}")
                    require(card_equal(got[0], v1[0]), f"filter {ver} != v1: {name}")
                errs[ver] = max(errs[ver], card_err(got[0], ref[0]), card_err(got[1], ref[1]))
        got = host(v1[1][1])[: int(v1[1][2])]
        require(np.array_equal(got, np.flatnonzero(v < t)), f"v1 rows != numpy: {name}")
        print(f"[filter alternates] {name} (n={n}), thresholds"
              f" {', '.join(f'{x:#x}' for x in thresholds)}: v2, v3, v4 == plain (and == v1 at"
              f" 2^30, padded with fill 7 too), with and without indices", flush=True)
    views = on_card(cases[2][1])
    for off in (1, 2, 3):  # a view that is not 16-byte aligned is read with 4-byte loads
        xv = views[off:]
        v1 = filter_cuda.filter_compact(xv, 7), filter_cuda.filter_with_indices(xv)
        for ver in alt.VERSIONS:
            got = alt.filter_compact(xv, ver, t, 7), alt.filter_with_indices(xv, ver, t)
            ref = alt.filter_compact_ref(xv, ver, t, 7), alt.filter_with_indices_ref(xv, ver, t)
            require(all(card_equal(g, r) and card_equal(g, w) for g, r, w in zip(got, ref, v1)),
                    f"filter {ver} != plain or v1 on a view at offset {off}")
    print("[filter alternates] v2, v3, v4 on views at offsets 1-3 of the 3·2^20+17 values:"
          " == plain and == v1, with and without indices", flush=True)
    torch.cuda.synchronize()
    t32 = timed.view(torch.int32)
    lib = library_ms("torch.masked_select",
                     lambda: torch.masked_select(t32, filter_cuda.below_threshold(timed)))
    rows = {}
    for ver in alt.VERSIONS:
        ms = cuda_ms(lambda: alt.filter_compact(timed, ver))
        plain_ms = cuda_ms(lambda: alt.filter_compact_ref(timed, ver))
        wi_ms = cuda_ms(lambda: alt.filter_with_indices(timed, ver))
        wi_plain = cuda_ms(lambda: alt.filter_with_indices_ref(timed, ver))
        replay = graph10_ms(lambda: alt.filter_compact(timed, ver))
        wi_replay = graph10_ms(lambda: alt.filter_with_indices(timed, ver))
        rows[ver] = {**kernel_row(errs[ver], ms, plain_ms, 8 * FILTER_N, lib),
                     "graph_ms": replay, "indices_ms": wi_ms, "indices_graph_ms": wi_replay,
                     "indices_plain_ms": wi_plain, "indices_bound_ms": bound_ms(12 * FILTER_N)}
        print(f"[filter {ver}] n={FILTER_N}: filter_compact kernel {ms:.4f} ms eager,"
              f" {replay:.4f} graph, plain {plain_ms:.4f} ms, bound {bound_ms(8 * FILTER_N):.4f}"
              f" ms; filter_with_indices kernel {wi_ms:.4f} ms eager, {wi_replay:.4f} graph,"
              f" plain {wi_plain:.4f} ms, bound {bound_ms(12 * FILTER_N):.4f} ms; predicate +"
              f" torch.masked_select {lib} ms (median of {REPS}, CUDA events; graph:"
              f" {GRAPH_CALLS} calls a replay) [{card}]", flush=True)
    return rows


def phase_filter_stages(rng, card: str) -> dict:
    """The stage ablation, v1's own sweep kernel cut at each stage (copy,
    count, prefix, lookback, full), bit for bit against its plain version
    on the card at 64Mi, 8Mi (the size measure_filter's parts section runs
    it at), 3·2^20+17 and 1; lookback on out[:count], since the stage
    leaves the rest unwritten. Each stage moves 8n bytes (the input read
    once, n values written), so they share one bound, except lookback,
    which writes only the count's values: 4n + 4·count. Timed at 64Mi: every
    stage and torch.clone (the copy stage's yardstick, the same bytes) over
    MP_ROUNDS interleaved rounds of eager readings, and once as graph
    replays; the differences between consecutive stages are printed as the
    attribution of v1's time (IO, predicate and count, rank and staging,
    look-back, tail)."""
    import torch

    from dpu_olap_tpu_torch.ops import filter_stages

    stage_names = filter_stages.STAGES
    err, timed = 0, None
    for n in (FILTER_N, MF_N, 3 * (1 << 20) + 17, 1):
        tv = on_card(rng.integers(0, 2**32, n, dtype=np.uint32))
        timed = timed if timed is not None else tv
        for stage in stage_names:
            got = list(filter_stages.filter_stage(tv, stage))
            ref = list(filter_stages.filter_stage_ref(tv, stage))
            require([g is None for g in got] == [r is None for r in ref],
                    f"filter stage {stage}: outputs differ from plain's (n={n})")
            if stage == "lookback":
                c = int(ref[2])
                got[0], ref[0] = got[0][:c], ref[0][:c]
            got = [g for g in got if g is not None]
            ref = [r for r in ref if r is not None]
            require(card_equal(got, ref), f"filter stage {stage} kernel != plain (n={n})")
            err = max(err, card_err(got, ref))
        print(f"[filter stages] n={n}: {', '.join(stage_names)} == plain (lookback on"
              f" [:count])", flush=True)
    torch.cuda.synchronize()
    bound = bound_ms(8 * FILTER_N)
    kept = int(filter_stages.filter_stage_ref(timed, "full")[2])
    fns = {s: (lambda s=s: filter_stages.filter_stage(timed, s)) for s in stage_names}
    fns["clone"] = timed.clone
    # single readings spread between calls, so MP_ROUNDS rounds in turns
    times = {k: [] for k in fns}
    for r in range(MP_ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[k].append(cuda_ms(fns[k]))
    med = {k: float(np.median(v)) for k, v in times.items()}
    replay = {k: graph10_ms(f) for k, f in fns.items()}
    stages = {s: {"ms": med[s], "graph_ms": replay[s],
                  "plain_ms": cuda_ms(lambda s=s: filter_stages.filter_stage_ref(timed, s)),
                  "bound_ms": bound_ms(4 * (FILTER_N + kept)) if s == "lookback" else bound}
              for s in stage_names}
    lib = med["clone"]
    faster = sum(c < t for c, t in zip(times["copy"], times["clone"]))
    print(f"[filter stages] n={FILTER_N}: "
          + "; ".join(f"{s} kernel {r['ms']:.4f} ms eager, {r['graph_ms']:.4f} graph, plain"
                      f" {r['plain_ms']:.4f}" for s, r in stages.items())
          + f"; torch.clone {lib:.4f} ms eager, {replay['clone']:.4f} graph; bound {bound:.4f}"
          f" ms each, lookback {stages['lookback']['bound_ms']:.4f} (eager: medians over {MP_ROUNDS} interleaved rounds of medians of {REPS},"
          f" CUDA events; graph: {GRAPH_CALLS} calls a replay) [{card}]", flush=True)
    print(f"[filter stages] copy against torch.clone over {MP_ROUNDS} rounds, ms: "
          + "; ".join(f"{k} min {min(times[k]):.4f} median {med[k]:.4f} max {max(times[k]):.4f}"
                      for k in ("copy", "clone"))
          + f"; copy faster in {faster} of {MP_ROUNDS} rounds [{card}]", flush=True)
    parts = ("IO", "predicate and count", "rank and staging", "look-back", "tail")
    for how, ms in (("eager", med), ("graph", replay)):
        steps = [ms[stage_names[0]]] + [ms[b] - ms[a] for a, b in zip(stage_names, stage_names[1:])]
        print(f"[filter stages] attribution of v1's time at n={FILTER_N} ({how}; full"
              f" {ms['full']:.4f} ms): " + "; ".join(f"{p} {d:+.4f} ms" for p, d in zip(parts, steps))
              + f" [{card}]", flush=True)
    copy = stages["copy"]
    return {**kernel_row(err, copy["ms"], copy["plain_ms"], 8 * FILTER_N, lib), "stages": stages,
            "clone_graph_ms": replay["clone"]}


def phase_measure_filter(card: str) -> dict:
    """The filter-kernel measurement entry point
    (python -m dpu_olap_tpu_torch.bench.measure_filter), all eight sections
    at their own sizes, with the launch counts of the alternates, the
    ablation, the block ops and the sort's tile stage set to 0 just before
    and read just after: each must launch, and no reading may lie under its
    floor."""
    import torch

    from dpu_olap_tpu_torch.bench import measure_filter
    from dpu_olap_tpu_torch.ops import block_ops_cuda, filter_alt_cuda, filter_stages, sort_cuda

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    filter_alt_cuda.LAUNCHES.update(dict.fromkeys(filter_alt_cuda.VERSIONS, 0))
    filter_stages.LAUNCHES = 0
    block_ops_cuda.LAUNCHES.update(dict.fromkeys(block_ops_cuda.LAUNCHES, 0))
    sort_cuda.TILE_LAUNCHES = 0
    t0 = time.perf_counter()
    results = measure_filter.run()
    launches = {f"filter{v[1]}": n for v, n in filter_alt_cuda.LAUNCHES.items()}
    launches["stages"] = filter_stages.LAUNCHES
    launches["block_ops"] = sum(block_ops_cuda.LAUNCHES[op] for op in block_ops_cuda.OPS)
    launches["block_cops"] = sum(block_ops_cuda.LAUNCHES[op] for op in block_ops_cuda.COPS)
    launches["tiles"] = sort_cuda.TILE_LAUNCHES
    require(all(v > 0 for v in launches.values()), f"measure_filter: launches {launches}")
    require(all(block_ops_cuda.LAUNCHES.values()),
            f"measure_filter: block op launches {block_ops_cuda.LAUNCHES}")
    low = [f"{s} {n}" for s, sec in results.items() for n, e in sec.items() if e.get("suspect")]
    require(not low, f"measure_filter: readings under their floor: {low}")
    print(f"[measure_filter] sections {list(results)}: launches {launches}, none under its floor;"
          f" {time.perf_counter() - t0:.1f} s, peak device memory"
          f" {torch.cuda.max_memory_allocated()} B [{card}]", flush=True)
    torch.cuda.empty_cache()
    return launches


def phase_measure_r3(card: str) -> dict:
    """The take/sum/probe/dense measurement entry point
    (python -m dpu_olap_tpu_torch.bench.measure_r3), the four sections that
    run the port's kernels (take2, sum, probe, dense; the take section times
    plain row gathers, no kernel), with the lane gather's launch count set
    to 0 just before and read just after: it must launch, and no reading
    may lie under its floor."""
    import torch

    from dpu_olap_tpu_torch.bench import measure_r3
    from dpu_olap_tpu_torch.ops import probes_cuda

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probes_cuda.LAUNCHES["lane_gather"] = 0
    t0 = time.perf_counter()
    results = measure_r3.run(("take2", "sum", "probe", "dense"))
    launches = {"lane_gather": probes_cuda.LAUNCHES["lane_gather"]}
    require(launches["lane_gather"] > 0, f"measure_r3: launches {launches}")
    low = [f"{s} {n}" for s, sec in results.items() for n, e in sec.items() if e.get("suspect")]
    require(not low, f"measure_r3: readings under their floor: {low}")
    print(f"[measure_r3] sections {list(results)}: launches {launches}, none under its floor;"
          f" {time.perf_counter() - t0:.1f} s, peak device memory"
          f" {torch.cuda.max_memory_allocated()} B [{card}]", flush=True)
    torch.cuda.empty_cache()
    return launches


def phase_probe_lowering(card: str) -> dict:
    """The lowering-probe entry point (python -m
    dpu_olap_tpu_torch.bench.probe_lowering), with the probe primitives'
    launch counts set to 0 just before and read just after: every probe OK,
    every primitive launched."""
    from dpu_olap_tpu_torch.bench import probe_lowering
    from dpu_olap_tpu_torch.ops import probes_cuda

    probes_cuda.LAUNCHES.update(dict.fromkeys(probes_cuda.LAUNCHES, 0))
    res = probe_lowering.run()
    require(all(res.values()), f"probe_lowering: FAIL {[k for k, ok in res.items() if not ok]}")
    launches = {k: probes_cuda.LAUNCHES[k] for k in probes_cuda.PRIMITIVES}
    require(all(launches.values()), f"probe_lowering: launches {launches}")
    print(f"[probe_lowering] {len(res)} probes OK: launches {launches} [{card}]", flush=True)
    return {"lowering": sum(launches.values())}


def graph_ms(fn) -> float:
    """cuda_ms of fn's calls captured once in one CUDA graph (the torch
    chain's time without the host's launch gaps)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_ms(g.replay)


def work_row(err, ms, plain_ms, nbytes, flops, lib_ms) -> dict:
    """kernel_row for work that also does bf16 tensor-core flops: the bound
    is the larger of the bytes' and the flops' times."""
    t_ops = flops / BF16_FLOPS * 1e3
    row = kernel_row(err, ms, plain_ms, nbytes, lib_ms)
    if t_ops > row["bound_ms"]:
        row.update(bound_ms=t_ops, bound_by="operations")
    return row


def _sum_rows(rows: dict, err: int, nbytes: int, flops: int) -> dict:
    """One kernels-line entry for several calls: each time the sum of one
    call of each, the bound that of the calls' bytes and flops together."""
    lib = [r["library_ms"] for r in rows.values()]
    return {**work_row(err, sum(r["ms"] for r in rows.values()),
                       sum(r["plain_ms"] for r in rows.values()), nbytes, flops,
                       None if None in lib else sum(lib)),
            "calls": rows}


def graph10_ms(fn) -> float:
    """graph_ms of GRAPH_CALLS calls of fn captured in one graph, each with
    its output kept, over the calls: a call's time without the single
    replay's fixed cost."""
    return graph_ms(lambda: [fn() for _ in range(GRAPH_CALLS)]) / GRAPH_CALLS


def _count_matmul_inputs(rng, nblk: int):
    """Tiles whose products are not all 0: v in [-2^14, 2^14) with the edge
    values (negative v, where v >> 7 is negative), half the indices equal to
    (v >> 7) & 127, the others any int32; from 2 tiles on the second is all
    0, where every sum of the first rep is 128."""
    x = rng.integers(-2**14, 2**14, (nblk * 128, 128), dtype=np.int64).astype(np.int32)
    x.flat[: len(EDGE_I32)] = EDGE_I32
    x[-1, -len(EDGE_I32):] = EDGE_I32
    idx = np.where(rng.random(x.shape) < 0.5, (x >> 7) & 127,
                   rng.integers(-2**31, 2**31, x.shape, dtype=np.int64)).astype(np.int32)
    idx.flat[: len(EDGE_I32)] = EDGE_I32
    if nblk > 1:
        x[128:256] = 0
        idx[128:256] = 0
    return on_card(x), on_card(idx)


def _block_inputs(rng, rows: int, nblk: int):
    """nblk blocks of int32 values over the whole range and indices over the
    whole int32 range (negative values and the +-2^31 edges included; a
    third of them near x >> 7, so that cprep's compare counts both ways)."""
    shape = (nblk * rows, 128)
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    x.flat[: len(EDGE_I32)] = EDGE_I32
    idx = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    near = (x.astype(np.int64) >> 7) + rng.integers(-2, 3, shape)
    idx = np.where(rng.random(shape) < 1 / 3, near, idx).astype(np.int32)
    idx.flat[: len(EDGE_I32)] = EDGE_I32[::-1]
    idx[-1, -len(EDGE_I32):] = EDGE_I32
    return on_card(x), on_card(idx)


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def phase_block_ops(rng, card: str) -> dict:
    """Every block op at its probe's block shape (OPS at 256 rows, COPS at
    128) bit for bit against its plain version on the card: on 1, 3, 64,
    128 and 264 blocks (264: more blocks than SMs and a partial last wave) at
    reps 0, 1, 2, 16 and 17 (17: the roll's shift cycles past 4), with
    values and indices over the whole int32 range; count_matmul also on 1,
    5, 128 and 264 tiles whose products are not all 0. Every op refuses a
    view 4 bytes past 16-byte alignment (x, and idx where the op reads it)
    without a launch. Each op timed at 2Mi values and reps 16 two ways: one
    call replayed from a CUDA graph (an eager call's time is mostly the
    host's), and per call from GRAPH_CALLS calls in one graph on the same
    x and idx (L2-hot); beside its bound (8 bytes an element for the ops
    that never read idx, 12 for the others), its plain version (eager) and
    the same torch chain captured the same two ways (torch.roll, torch.where, torch.gather, .transpose, a
    bf16 batched matmul of the 0/1 planes). The printed line also gives the
    on-chip floor of the gathers and the transpose, worked out, not timed:
    every value through shared memory once in and once out a rep, at 128 B
    a clock an SM at the card's highest SM clock."""
    import torch

    from dpu_olap_tpu_torch.ops import block_ops_cuda as bo

    errs = dict.fromkeys(bo.OPS + bo.COPS, 0)
    for op in bo.OPS + bo.COPS:
        for nblk in (1, 3, 64, 128, 264):
            x, idx = _block_inputs(rng, bo.ROWS[op], nblk)
            for reps in (0, 1, 2, OP_REPS, OP_REPS + 1):
                got = bo.block_op(x, idx, op, reps)
                ref = bo.block_op_ref(x, idx, op, reps)
                require(card_equal([got], [ref]), f"block op {op} != plain: {nblk} blocks, reps {reps}")
                errs[op] = max(errs[op], card_err([got.reshape(-1)], [ref.reshape(-1)]))
        rows = bo.ROWS[op]
        flat = torch.zeros(rows * 128 + 4, dtype=torch.int32, device="cuda")
        view, good = flat[1: 1 + rows * 128].view(rows, 128), flat[4:].view(rows, 128)
        before = bo.LAUNCHES[op]
        for args in ((view, good), (good, view))[: 1 if op in bo.IDX_FREE else 2]:
            try:
                bo.block_op(*args, op, 1)
            except ValueError:
                continue
            raise SmokeFailure(f"block op {op} took a view 4 bytes past 16-byte alignment")
        require(bo.LAUNCHES[op] == before, f"block op {op}: a refused view launched")
        print(f"[block ops] {op}: kernel == plain on 1, 3, 64, 128 and 264 blocks of"
              f" {rows} rows, reps 0, 1, 2, {OP_REPS}, {OP_REPS + 1}, indices over the int32"
              f" range; misaligned views refused", flush=True)
    for nblk in (1, 5, 128, 264):
        cx, ci = _count_matmul_inputs(rng, nblk)
        for reps in (0, 1, 2, OP_REPS, OP_REPS + 1):
            got = bo.block_op(cx, ci, "count_matmul", reps)
            ref = bo.block_op_ref(cx, ci, "count_matmul", reps)
            require(card_equal([got], [ref]), f"count_matmul != plain: {nblk} tiles, reps {reps}")
            errs["count_matmul"] = max(errs["count_matmul"],
                                       card_err([got.reshape(-1)], [ref.reshape(-1)]))
    print(f"[block ops] count_matmul: kernel == plain on 1, 5, 128 and 264 tiles, reps 0, 1, 2,"
          f" {OP_REPS}, {OP_REPS + 1}, products not all 0", flush=True)
    torch.cuda.synchronize()

    xs = rng.integers(-2**31, 2**31, BLOCK_N, dtype=np.int64).astype(np.int32)
    xs[: len(EDGE_I32)] = EDGE_I32
    xs[-len(EDGE_I32):] = EDGE_I32
    x = on_card(xs).view(-1, 128)
    idx = on_card(rng.integers(0, 128, BLOCK_N, dtype=np.int32)).view(-1, 128)
    smem_rate = torch.cuda.get_device_properties(0).multi_processor_count * 128 * sm_clock_hz()
    onchip = {op: 2 * 4 * BLOCK_N * OP_REPS / smem_rate * 1e3
              for op in ("lane_gather", "sublane_gather", "sq_gather", "transpose")}
    out = {}
    for entry, ops in (("block_ops", bo.OPS), ("block_cops", bo.COPS)):
        calls, nbytes = {}, {}
        for op in ops:
            flops = 2 * 128**3 * OP_REPS * (BLOCK_N // (128 * 128)) if op == "count_matmul" else 0
            nbytes[op] = (8 if op in bo.IDX_FREE else 12) * BLOCK_N

            def kern(op=op):
                return bo.block_op(x, idx, op, OP_REPS)

            def chain(op=op):
                return bo.block_op_ref(x, idx, op, OP_REPS, matmul_dtype=torch.bfloat16)

            calls[op] = work_row(errs[op], graph_ms(kern),
                                 cuda_ms(lambda: bo.block_op_ref(x, idx, op, OP_REPS)),
                                 nbytes[op], flops, graph_ms(chain))
            calls[op].update(graph10_ms=graph10_ms(kern), library_graph10_ms=graph10_ms(chain))
        total_flops = 2 * 128**3 * OP_REPS * (BLOCK_N // (128 * 128)) * ("count_matmul" in ops)
        out[entry] = _sum_rows(calls, max(errs[op] for op in ops), sum(nbytes.values()),
                               total_flops)
        print(f"[{entry}] {BLOCK_N} values in {bo.ROWS[ops[0]]}-row blocks, {OP_REPS} ops a call: "
              + "; ".join(f"{op} kernel {r['ms']:.4f} ms ({r['graph10_ms']:.4f} a call of"
                          f" {GRAPH_CALLS}), plain {r['plain_ms']:.4f}, torch chain in one graph"
                          f" {r['library_ms']:.4f} ({r['library_graph10_ms']:.4f}), bound"
                          f" {r['bound_ms']:.4f} ({r['bound_by']})"
                          + (f", on-chip floor {onchip[op]:.4f}" if op in onchip else "")
                          for op, r in calls.items())
              + f" (median of {REPS}; kernel and chain: graph replays of one call and of"
                f" {GRAPH_CALLS}; shared memory {smem_rate / 1e12:.2f} TB/s at the highest SM"
                f" clock) [{card}]", flush=True)
    return out


def phase_probes(rng, card: str) -> dict:
    """The lane gather at measure_r3's shapes (8192 and 32768 rows of 128
    int32) and the lowering probes' primitives at theirs, each bit for bit
    against its plain version on the card (out-of-range gather indices and
    rows too); the lane gather also at 1 to 32768 rows of 128 and 256
    indices over 128 values (the warp-a-row kernel) and over 129 and 2048
    (the staged kernel), either side of gather_plan's threshold, and on
    views that do not start 16-byte aligned; the one-hot product also at K
    of 16 to 4096 and M and N of 16 to 256. Each is timed beside its bound, its plain
    version and one torch call (torch.gather, .t().contiguous(), a bf16
    torch.matmul, index_select), each replayed from a CUDA graph, since an
    eager call of these small kernels times the host's launch, not the
    card: one call replayed, and per call from GRAPH_CALLS calls in one
    graph. The lowering probes are also read against the launch floor, the
    time of the noop kernel through the same path, taken the same two ways
    in the same run: each gets its share of the larger of its bound and the
    floor, a call of GRAPH_CALLS, and a reading under the floor is flagged,
    never clamped."""
    import torch

    from dpu_olap_tpu_torch.ops import probes_cuda as pc

    def u32(shape):
        return on_card(rng.integers(0, 2**32, shape, dtype=np.uint32))

    def gather_inputs(rows, wi, wv=128):
        x = on_card(rng.integers(0, 2**31, (rows, wv), dtype=np.int32))
        i = rng.integers(0, wv, (rows, wi), dtype=np.int32)
        i[0, :3] = [-1, wv, 2**31 - 1]
        i[-1, -3:] = [wv, -1, -2**31]
        return x, on_card(i)

    def misaligned(t):  # the same values in a contiguous view 4 bytes past 16
        view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
        view.copy_(t)
        return view

    gather_err = 0
    edge_rows = (1, 31, 32, 33, 128, 4223, 4224, 8192, 32768)
    for rows in edge_rows:
        for wi in (128, 256):
            for wv in (128, 129, 2048) if rows <= 4224 else (128,):
                x, i = gather_inputs(rows, wi, wv)
                kernel = pc.gather_plan(rows, wv, wi).kernel
                for vx, vi, how in ((x, i, ""), (misaligned(x), i, ", x misaligned"),
                                    (x, misaligned(i), ", idx misaligned")):
                    got, ref = pc.lane_gather(vx, vi), pc.lane_gather_ref(vx, vi)
                    require(card_equal([got], [ref]), f"lane_gather ({kernel}) != plain: {rows}"
                            f" rows of {wi} indices over {wv} values{how}")
                    gather_err = max(gather_err, card_err([got.view(-1)], [ref.view(-1)]))
    print(f"[lane_gather] == plain at {', '.join(map(str, edge_rows))} rows of 128 and 256"
          f" indices over 128 values (warp_rows), and up to 4224 rows over 129 and 2048 values"
          f" (staged), out-of-range indices, x or idx 4 bytes past 16-byte alignment",
          flush=True)
    onehot_err = 0
    for k in (16, 128, 144, 4096):
        for m in (16, 48, 128, 256):
            for n in (16, 48, 128, 256):
                oa, ob = (on_card(rng.integers(0, 2, s).astype(np.float32)).to(torch.bfloat16)
                          for s in ((k, m), (k, n)))
                got, ref = pc.onehot_matmul(oa, ob), pc.onehot_matmul_ref(oa, ob)
                require(card_equal([got], [ref]), f"onehot_matmul != plain: K {k}, M {m}, N {n}")
                onehot_err = max(onehot_err, card_err([got.view(-1)], [ref.view(-1)]))
    print("[lowering probes] onehot_matmul == plain at K 16, 128, 144, 4096 x M, N 16, 48, 128,"
          " 256", flush=True)
    gathers = {}
    for rows in (8192, 32768):
        x, i = gather_inputs(rows, 128)
        got, ref = pc.lane_gather(x, i), pc.lane_gather_ref(x, i)
        require(card_equal([got], [ref]), f"lane_gather != plain: {rows} rows")
        i64 = i.to(torch.int64).clamp(0, 127)

        def kern(x=x, i=i):
            return pc.lane_gather(x, i)

        def lib(x=x, i64=i64):
            return torch.gather(x, 1, i64)

        gathers[rows] = kernel_row(
            max(gather_err, card_err([got.view(-1)], [ref.view(-1)])), graph_ms(kern),
            graph_ms(lambda: pc.lane_gather_ref(x, i)), 12 * rows * 128, graph_ms(lib))
        gathers[rows].update(graph10_ms=graph10_ms(kern), library_graph10_ms=graph10_ms(lib))
    a, b = (on_card(rng.integers(0, 2, s).astype(np.float32)).to(torch.bfloat16)
            for s in ((128, 128), (128, 256)))
    wx, wi = u32((128, 128)), on_card(rng.integers(0, 128, (128, 256), dtype=np.int32))
    wi64 = wi.to(torch.int64)
    dx = u32((512, 128))
    rows = {f"dyn_row {r}": on_card(np.array([r], np.int32)) for r in (317, -1)}
    probes = {  # name: (kernel call, plain call, library call, bytes, flops)
        **{f"transpose {s[0]}x{s[1]} {dt}": (
            lambda t=t: pc.transpose(t), lambda t=t: pc.transpose_ref(t),
            lambda t=t: t.t().contiguous(), 8 * s[0] * s[1], 0)
           for s, dt, t in (((128, 128), "u32", u32((128, 128))),
                            ((128, 128), "i32", u32((128, 128)).view(torch.int32)),
                            ((512, 128), "u32", u32((512, 128))))},
        "gather idx(128,256) over vals(128,128)": (
            lambda: pc.lane_gather(wx, wi), lambda: pc.lane_gather_ref(wx, wi),
            lambda: torch.gather(wx.view(torch.int32), 1, wi64),
            4 * (128 * 128 + 2 * 128 * 256), 0),
        "one-hot (128,128)^T@(128,256)": (
            lambda: pc.onehot_matmul(a, b), lambda: pc.onehot_matmul_ref(a, b),
            lambda: torch.matmul(a.t(), b), 2 * 128 * (128 + 256) + 4 * 128 * 256,
            2 * 128 * 128 * 256),
        **{name: (lambda r=r: pc.dyn_row(dx, r), lambda r=r: pc.dyn_row_ref(dx, r),
                  lambda r=r: dx.view(torch.int32).index_select(0, r.clamp(0, 511).long()),
                  8 * 128, 0) for name, r in rows.items()},
    }
    # every probe call, its torch call and the noop, read in turns: a call
    # of these is a few microseconds, near the launch floor it is held to
    timed = {("noop", "kernel"): pc.noop}
    for name, (kern, _, lib, _, _) in probes.items():
        timed.update({(name, "kernel"): kern, (name, "library"): lib})
    one = interleaved({k: (lambda f=f: graph_ms(f)) for k, f in timed.items()})
    ten = interleaved({k: (lambda f=f: graph10_ms(f)) for k, f in timed.items()},
                      rounds=PROBE_ROUNDS)
    floor = {"ms": one[("noop", "kernel")], "graph10_ms": ten[("noop", "kernel")]}
    calls, err, nbytes, flops = {}, onehot_err, 0, 0
    for name, (kern, plain, lib, nb, fl) in probes.items():
        got, ref = kern(), plain()
        require(card_equal([got], [ref]), f"lowering probe {name}: kernel != plain")
        require(got.dtype == ref.dtype, f"lowering probe {name}: dtype {got.dtype} != {ref.dtype}")
        e = card_err([got.reshape(-1).view(torch.int32)], [ref.reshape(-1).view(torch.int32)])
        if name.startswith("gather"):
            e = max(e, gather_err)
        err = max(err, e)
        calls[name] = work_row(e, one[(name, "kernel")], graph_ms(plain), nb, fl,
                               one[(name, "library")])
        calls[name].update(graph10_ms=ten[(name, "kernel")],
                           library_graph10_ms=ten[(name, "library")])
        calls[name].update(floor_row(calls[name], floor))
        nbytes, flops = nbytes + nb, flops + fl
    print("[lane_gather] " + "; ".join(
        f"{r} rows: kernel == plain, kernel {g['ms']:.4f} ms ({g['graph10_ms']:.4f} a call of"
        f" {GRAPH_CALLS}), plain {g['plain_ms']:.4f}, torch.gather {g['library_ms']:.4f}"
        f" ({g['library_graph10_ms']:.4f}), bound {g['bound_ms']:.4f}"
        for r, g in gathers.items())
        + f" (median of {REPS} graph replays of one call and of {GRAPH_CALLS}, CUDA events)"
          f" [{card}]", flush=True)
    print(f"[lowering probes] launch floor (noop kernel through the probes' path):"
          f" {floor['ms']:.4f} ms one call replayed, {floor['graph10_ms']:.4f} a call of"
          f" {GRAPH_CALLS}; " + "; ".join(
        f"{n}: kernel == plain, kernel {r['ms']:.4f} ms ({r['graph10_ms']:.4f} a call of"
        f" {GRAPH_CALLS}), plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}"
        f" ({r['library_graph10_ms']:.4f}), bound {r['bound_ms']:.6f}, share of max(bound,"
        f" floor) {r['floor_share']:.2f} a call of {GRAPH_CALLS}"
        + (" UNDER THE FLOOR" if r["under_floor"] else "") for n, r in calls.items())
        + f" (kernel, library and floor in turns: one call replayed, median of 3 rounds; a"
          f" call of {GRAPH_CALLS} in one graph, median of {PROBE_ROUNDS} rounds; each reading"
          f" the median of {REPS} replays, CUDA events) [{card}]", flush=True)
    return {"lane_gather": {**gathers[32768], "rows_8192": gathers[8192]},
            "lowering_probes": _sum_rows(calls, err, nbytes, flops)}


def floor_row(row: dict, floor: dict) -> dict:
    """A reading's launch floor (the noop's time, one call replayed and a
    call of GRAPH_CALLS), and, from the call of GRAPH_CALLS (one call
    replayed carries the replay's own fixed cost), its share of max(bound,
    floor) and whether it lies under the floor (flagged, never clamped)."""
    return {"launch_floor_ms": floor["ms"], "launch_floor_graph10_ms": floor["graph10_ms"],
            "floor_share": max(row["bound_ms"], floor["graph10_ms"]) / row["graph10_ms"],
            "under_floor": row["graph10_ms"] < floor["graph10_ms"]}


def phase_sort_tiles(rng, card: str) -> dict:
    """The sort's tile stage against its plain version on the card: keys
    equal as they are, payloads after a canonical order of each tile (the
    tile sort is unstable); at 2Mi with 1 payload (measure_filter's sort
    section), 3*4096+5 with 3, 4097 with 8, 100 with 0 and 2 with 1, and a
    tile of 0xFFFFFFFF keys beside the pad; timed at 2Mi eager and replayed
    beside its bound, its plain version and torch.sort of the key's
    4096-element rows."""
    import torch

    from dpu_olap_tpu_torch.ops import sort_cuda

    err, timed = 0, None
    for n, n_pay, top in ((SF1_ROWS, 1, 2**31), (3 * 4096 + 5, 3, 2**31), (4097, 8, 2**31),
                          (100, 0, 2**31), (2, 1, 2**31), (4096 + 9, 2, None)):
        key = (rng.integers(0, top, n, dtype=np.uint32) if top
               else np.full(n, 0xFFFFFFFF, np.uint32))
        key[-min(n, 64):] = key[0]  # ties
        planes = tuple(on_card(p) for p in (key, *(rng.integers(0, 2**32, n, dtype=np.uint32)
                                                   for _ in range(n_pay))))
        got, ref = sort_cuda.sort_tiles(planes), sort_cuda.sort_tiles_ref(planes)
        require(card_equal(got[:1], ref[:1]), f"sort_tiles keys != plain (n={n})")
        cg, cr = sort_cuda.canonical_tiles(got), sort_cuda.canonical_tiles(ref)
        require(card_equal(cg, cr), f"sort_tiles rows != plain (n={n}, payloads {n_pay})")
        err = max(err, card_err(cg, cr))
        timed = timed or planes
        print(f"[sort_tiles] n={n} payloads={n_pay}{'' if top else ' keys 0xFFFFFFFF'}:"
              " kernel == plain", flush=True)
    torch.cuda.synchronize()
    k32 = timed[0].view(torch.int32).view(-1, sort_cuda.TILE)
    row = kernel_row(err, cuda_ms(lambda: sort_cuda.sort_tiles(timed)),
                     cuda_ms(lambda: sort_cuda.sort_tiles_ref(timed)), 16 * SF1_ROWS,
                     library_ms("torch.sort of 4096-element rows", lambda: torch.sort(k32, dim=1)))
    row["graph_ms"] = graph10_ms(lambda: sort_cuda.sort_tiles(timed))
    row["library_graph_ms"] = graph10_ms(lambda: torch.sort(k32, dim=1))
    print(f"[sort_tiles] n={SF1_ROWS} 1 payload: kernel {row['ms']:.4f} ms eager,"
          f" {row['graph_ms']:.4f} graph, plain {row['plain_ms']:.4f} ms, torch.sort of the key's"
          f" rows {row['library_ms']} ms eager, {row['library_graph_ms']:.4f} graph, bound"
          f" {row['bound_ms']:.4f} ms (median of {REPS}, CUDA events; graph: {GRAPH_CALLS} calls"
          f" a replay) [{card}]", flush=True)
    return row


def phase_sum_kernel(rng, card: str) -> dict:
    """Sum kernel == plain, exactly, on the card; timed at 16Mi."""
    import torch

    from dpu_olap_tpu_torch.ops import sum_cuda
    from dpu_olap_tpu_torch.ops.aggregate import u64_pair_to_int

    big = on_card(rng.integers(0, 2**32, SUM_N + 7, dtype=np.uint32))
    cases = [
        ("random 16Mi", big[:SUM_N]),
        ("misaligned view 16Mi+6", big[1:]),
        ("misaligned view 5", big[3:8]),
        ("all 0xFFFFFFFF 2^24", on_card(np.full(1 << 24, 0xFFFFFFFF, np.uint32))),
    ] + [(f"random {n}", big[:n]) for n in (0, 1, 3, 4, 1029)]
    err = 0
    for name, t in cases:
        truth = int(host(t).astype(np.uint64).sum(dtype=np.uint64))
        got = u64_pair_to_int(*sum_cuda.sum_u64_pair(t))
        ref = u64_pair_to_int(*sum_cuda.sum_u64_pair_ref(t))
        require(ref == truth, f"plain sum {name}: {ref} != {truth}")
        require(got == ref, f"sum kernel != plain: {name}: {got} != {ref}")
        err = max(err, abs(got - ref))
        print(f"[sum] {name}: kernel == plain == numpy ({got})", flush=True)
    t = cases[0][1]
    ms = cuda_ms(lambda: sum_cuda.sum_u64_pair(t))
    plain_ms = cuda_ms(lambda: sum_cuda.sum_u64_pair_ref(t))
    lib = library_ms("uint32 sum(dtype=int64)", lambda: t.sum(dtype=torch.int64))
    nbytes = 4 * SUM_N
    print(
        f"[sum] n={SUM_N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" x.sum(dtype=torch.int64) {lib} ms, bound {bound_ms(nbytes):.4f} ms"
        f" (median of {REPS}, CUDA events) [{card}]",
        flush=True,
    )
    return kernel_row(err, ms, plain_ms, nbytes, lib)


def phase_fill_kernels(rng, card: str) -> dict:
    """propagate_fill and propagate_last kernels == plain, bit for bit on
    every lane, on the card; timed at 8Mi. Returns the measurements and the
    propagate_last launches of this phase."""
    import torch

    from dpu_olap_tpu_torch.ops import scan_cuda

    def check(name, alive, pays):
        n = len(alive)
        key = np.where(alive, rng.integers(0, 2**31, n, dtype=np.uint32), np.uint32(0xFFFFFFFF))
        planes = (on_card(key), *(on_card(p) for p in pays))
        got = [host(t) for t in scan_cuda.propagate_fill(planes)]
        ref = [host(t) for t in scan_cuda.propagate_fill_ref(planes)]
        src = np.maximum.accumulate(np.where(alive, np.arange(n), -1))
        has = src >= 0
        require(np.array_equal(ref[0][has], key[src[has]]) and np.all(ref[0][~has] == 0xFFFFFFFF),
                f"plain fill {name}")
        require(all(np.array_equal(g, r) for g, r in zip(got, ref)), f"fill kernel != plain: {name}")
        before = scan_cuda.LAUNCHES
        ta = on_card(alive)
        gh, go = scan_cuda.propagate_last(ta, planes[1:])
        rh, ro = scan_cuda.propagate_last_ref(ta, planes[1:])
        counts["last"] += scan_cuda.LAUNCHES - before
        require(np.array_equal(host(rh), has), f"plain propagate_last has {name}")
        require(np.array_equal(host(gh), host(rh)) and all(
            np.array_equal(host(g), host(r)) for g, r in zip(go, ro)),
            f"propagate_last kernel != plain: {name}")
        err[0] = max(err[0], *(max_err(g, r) for g, r in zip(got, ref)))
        err[1] = max(err[1], *(max_err(host(g), host(r)) for g, r in zip(go, ro)))
        print(f"[fill] {name} (n={n}, live {int(alive.sum())}): fill and last kernels == plain",
              flush=True)

    counts, err = {"last": 0}, [0, 0]
    # lengths around the kernel's tile of 4096, and not a multiple of 4
    for n in (FILL_N, 3 * (1 << 20) + 17, 1, 4095, 4096, 4097):
        for density in (0.0, 0.002, 0.5, 1.0):
            pays = [rng.integers(0, 2**32, n, dtype=np.uint32)]
            check(f"density {density}", rng.random(n) < density, pays)
    # one live element just before a 4096-boundary carried across every
    # later tile, and payloads with the top bit set
    for pos in (4094, 4095, 4096, FILL_N - 4097):
        alive = np.zeros(FILL_N, bool)
        alive[pos] = True
        pays = [rng.integers(0x80000000, 2**32, FILL_N, dtype=np.uint32) for _ in range(2)]
        check(f"single live at {pos}", alive, pays)
    # dead runs of many tiles that end in one live lane: at the end, and
    # between a live head and a dead tail
    for name, head in (("dead run, one live lane last", 0), ("live head, dead run, one live", 100)):
        alive = np.zeros(FILL_N, bool)
        alive[:head] = rng.random(head) < 0.5
        alive[FILL_N - 1 if head == 0 else FILL_N // 2 + 3] = True
        check(name, alive, [rng.integers(0, 2**32, FILL_N, dtype=np.uint32)])

    alive = rng.random(FILL_N) < 0.18  # the TPC-H merge's share of pk rows
    key = np.where(alive, rng.integers(0, 2**31, FILL_N, dtype=np.uint32), np.uint32(0xFFFFFFFF))
    planes = (on_card(key), on_card(rng.integers(0, 2**32, FILL_N, dtype=np.uint32)),
              on_card(rng.integers(0, 2**32, FILL_N, dtype=np.uint32)))
    ta = on_card(alive)

    def both(pl, al):
        has, last = scan_cuda.propagate_last(al, pl[1:])
        return (*scan_cuda.propagate_fill(pl), has, *last)

    def both_ref(pl, al):
        has, last = scan_cuda.propagate_last_ref(al, pl[1:])
        return (*scan_cuda.propagate_fill_ref(pl), has, *last)

    for off in (1, 2, 3):  # planes and alive bytes that are not 16-byte aligned
        pl, al = tuple(p[off:] for p in planes), ta[off:]
        require(card_equal(both(pl, al), both_ref(pl, al)),
                f"fill kernels != plain on views at offset {off}")
    first = both(planes, ta)
    require(card_equal(first, both(planes, ta)) and card_equal(first, both_ref(planes, ta)),
            "fill kernels: two calls in a row differ, or differ from plain")
    gp, ga = tuple(p.clone() for p in planes), ta.clone()  # the graph's inputs
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both(gp, ga)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both(gp, ga)
    for r, density in enumerate((0.3, 0.001)):  # each replay clears and reuses the work memory
        live = torch.rand(FILL_N, device="cuda") < density
        gp[0].copy_(torch.where(live, gp[0].to(torch.int64) & 0x7FFFFFFF, 0xFFFFFFFF)
                    .to(torch.uint32))
        ga.copy_(live)
        graph.replay()
        require(card_equal(captured, both_ref(gp, ga)), f"fill kernels != plain in replay {r}")
    del graph, captured, first, gp, ga
    print("[fill] fill and last kernels == plain on views at offsets 1-3, in two calls in a row"
          " and in two CUDA-graph replays", flush=True)

    planes = planes[:2]
    torch.cuda.synchronize()
    fill_ms = cuda_ms(lambda: scan_cuda.propagate_fill(planes))
    fill_plain = cuda_ms(lambda: scan_cuda.propagate_fill_ref(planes))
    last_ms = cuda_ms(lambda: scan_cuda.propagate_last(ta, planes[1:]))
    last_plain = cuda_ms(lambda: scan_cuda.propagate_last_ref(ta, planes[1:]))
    fill_graph = graph10_ms(lambda: scan_cuda.propagate_fill(planes))
    last_graph = graph10_ms(lambda: scan_cuda.propagate_last(ta, planes[1:]))
    print(
        f"[fill] n={FILL_N} key + 1 payload: propagate_fill kernel {fill_ms:.4f} ms eager,"
        f" {fill_graph:.4f} graph, plain {fill_plain:.4f} ms; propagate_last kernel"
        f" {last_ms:.4f} ms eager, {last_graph:.4f} graph, plain {last_plain:.4f} ms"
        f" (median of {REPS}, CUDA events; graph: {GRAPH_CALLS} calls a replay) [{card}]",
        flush=True,
    )
    # no PyTorch call computes a segmented forward fill: no library time
    return {
        "propagate_fill": {**kernel_row(err[0], fill_ms, fill_plain, 2 * 2 * 4 * FILL_N, None),
                           "graph_ms": fill_graph},
        # alive bytes and the plane read, has and the plane written
        "propagate_last": {**kernel_row(err[1], last_ms, last_plain, 2 * 5 * FILL_N, None),
                           "graph_ms": last_graph},
        "last_launches": counts["last"],
    }


MERGE_TOP_BIT = np.array([0, 1, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _bitonic_planes(rng, n: int, block: int, hi: int, n_pay: int, kind: str = "below"):
    """Planes whose every block is an ascending run then a descending one;
    keys below hi, all equal, or drawn from the top-bit edges."""
    if kind == "equal":
        key = np.full(n, 7, np.uint32)
    elif kind == "top_bit":
        key = MERGE_TOP_BIT[rng.integers(0, len(MERGE_TOP_BIT), n)]
    else:
        key = rng.integers(0, hi, n, dtype=np.uint32)
    key = key.reshape(-1, 2, block // 2)
    key.sort(axis=2)
    key[:, 1] = key[:, 1, ::-1]
    return [key.reshape(n), *(rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay))]


def _join_merge_planes(rng):
    """The sorted-build join's bitonic_merge input at TPC-H SF=1, laid out as
    ops/merge.py's join_shard_sorted_build lays it out: [ascending o_orderkey
    << 1 | 0xFFFFFFFF pad | descending l_orderkey << 1 | 1] over FILL_N, one
    merged payload plane (x, 0 in the pad, the sorted lineitems' y)."""
    i = np.arange(TPCH_ORDERS, dtype=np.uint32)
    okey = (i // 8) * 32 + i % 8 + 1
    k2_l = np.sort((np.repeat(okey, rng.integers(1, 8, TPCH_ORDERS)) << 1) | 1)[::-1]
    pad = FILL_N - TPCH_ORDERS - k2_l.size
    key = np.concatenate([okey << 1, np.full(pad, 0xFFFFFFFF, np.uint32), k2_l])
    pay = np.concatenate([rng.integers(0, 2**32, TPCH_ORDERS, dtype=np.uint32),
                          np.zeros(pad, np.uint32),
                          rng.integers(0, 2**32, k2_l.size, dtype=np.uint32)])
    return [on_card(key), on_card(pay)]


def phase_merge_kernels(rng, card: str) -> dict:
    """bitonic_merge_blocks kernel == plain, bit for bit (ties in every
    case), on the card, at blocks that reach every pass structure of
    merge_plan (the tile pass alone on 128- and 4096-element tiles and on
    whole SET tiles, one strided pass of 2 and of 9 stages, two strided
    passes); bitonic_merge at the sorted-build join's 8Mi call, timed eager
    and replayed beside torch.sort of its key (a yardstick: a sort is not the
    same function)."""
    import torch

    from dpu_olap_tpu_torch.ops import bitonic_cuda, merge, sort_cuda

    err = 0
    cases = [(128, FILL_N + 128, 16, 3, "below"), (4096, FILL_N + 4096, 16, 8, "below"),
             (bitonic_cuda.SET, FILL_N, 16, 0, "below"), (1 << 16, FILL_N, 16, 1, "below"),
             (FILL_N, FILL_N, 16, 1, "below"), (FILL_N, FILL_N, 0, 2, "equal"),
             (FILL_N, FILL_N, 0, 1, "top_bit"), (2 * FILL_N, 2 * FILL_N, 16, 0, "below")]
    for block, n, hi, n_pay, kind in cases:
        planes = [on_card(p) for p in _bitonic_planes(rng, n, block, hi, n_pay, kind)]
        got = bitonic_cuda.bitonic_merge_blocks(planes, block // 128)
        ref = bitonic_cuda.bitonic_merge_blocks_ref(planes, block // 128)
        k = ref[0].to(torch.int64).view(-1, block)
        require(bool((k[:, 1:] >= k[:, :-1]).all()), f"plain merge blocks of {block}: not sorted")
        require(card_equal(got, ref), f"merge_blocks kernel != plain: block {block}, {kind}")
        err = max(err, card_err(got, ref))
        passes = len(bitonic_cuda.merge_plan(n, block, n_pay))
        print(f"[merge] bitonic_merge_blocks n={n} block={block} payloads={n_pay} keys {kind}"
              f"{f' {hi}' if hi else ''} ({passes} passes): kernel == plain", flush=True)
        del planes, got, ref, k
    timed = _join_merge_planes(rng)
    for planes in (timed, [on_card(p) for p in _bitonic_planes(rng, FILL_N, FILL_N, 2**31, 3)]):
        got = merge.bitonic_merge(planes)
        ref = bitonic_cuda.bitonic_merge_blocks_ref(planes, FILL_N // 128)
        require(torch.equal(ref[0].to(torch.int64), torch.sort(planes[0].to(torch.int64)).values),
                "plain bitonic_merge keys")
        require(card_equal(got, ref), f"bitonic_merge kernel != plain: {len(planes) - 1} payloads")
        err = max(err, card_err(got, ref))
        print(f"[merge] bitonic_merge n={FILL_N} payloads={len(planes) - 1}: kernel == plain",
              flush=True)
    # below one 128-element block the ported sort finishes the merge
    host_planes = _bitonic_planes(rng, 64, 64, 16, 2)
    planes = [on_card(p) for p in host_planes]
    before = sort_cuda.LAUNCHES
    got = [host(t) for t in merge.bitonic_merge(planes)]
    ref = [host(t) for t in sort_cuda.sort_bitonic_ref(planes)]
    require(sort_cuda.LAUNCHES == before + 1, "bitonic_merge n=64 did not launch the sort kernel")
    require(np.array_equal(got[0], np.sort(host_planes[0])) and np.array_equal(canon(got), canon(ref)),
            "bitonic_merge n=64 (sort kernel) != plain")
    print("[merge] bitonic_merge n=64 payloads=2: sort kernel == plain", flush=True)
    torch.cuda.synchronize()
    key32 = timed[0].view(torch.int32)
    ms = cuda_ms(lambda: merge.bitonic_merge(timed))
    graph = graph10_ms(lambda: merge.bitonic_merge(timed))
    plain_ms = cuda_ms(lambda: bitonic_cuda.bitonic_merge_blocks_ref(timed, FILL_N // 128))
    sort_ms = cuda_ms(lambda: torch.sort(key32))
    sort_graph = graph10_ms(lambda: torch.sort(key32))
    blocks = [on_card(p) for p in _bitonic_planes(rng, FILL_N, 1 << 16, 16, 1)]
    blk_ms = cuda_ms(lambda: bitonic_cuda.bitonic_merge_blocks(blocks))
    print(
        f"[merge] n={FILL_N} 1 payload, the sorted-build join's call (TPC-H SF=1 keys):"
        f" bitonic_merge kernel {ms:.4f} ms eager, {graph:.4f} graph, plain {plain_ms:.4f} ms,"
        f" bound {bound_ms(16 * FILL_N):.4f} ms; torch.sort of its key (yardstick) {sort_ms:.4f}"
        f" eager, {sort_graph:.4f} graph; bitonic_merge_blocks (64Ki blocks) {blk_ms:.4f} ms eager"
        f" (median of {REPS}, CUDA events; graph: {GRAPH_CALLS} calls a replay) [{card}]",
        flush=True,
    )
    # no PyTorch call merges a bitonic sequence: no library time
    return {**kernel_row(err, ms, plain_ms, 2 * 2 * 4 * FILL_N, None), "graph_ms": graph,
            "torch_sort_ms": sort_graph}


def phase_partition_kernel(rng, card: str) -> dict:
    """partition_cells kernel == plain, bit for bit on every lane (cells,
    selection, counts, flag), on the card, at the operators' shapes and the
    sweep's edges (tile edges, one bucket, cut-off inside a tile, two
    payload groups); timed eager and as graph replays beside a stable
    torch.sort of the bucket, with its per-launch breakdown, at 16Mi keys + 1
    payload into 8 cells (partition_kernel_p8 at SF=8) and at one SF=64
    side."""
    import torch

    from dpu_olap_tpu_torch.bench import kernel_replay
    from dpu_olap_tpu_torch.ops import partition_cuda
    from dpu_olap_tpu_torch.ops.hashing import bucket_shift, wang_hash

    def check(name, keys, n_pay, p, cell, overflow=False):
        pays = [on_card(rng.integers(0, 2**32, len(keys), dtype=np.uint32)) for _ in range(n_pay)]
        tk = on_card(keys)
        got = partition_cuda.partition_cells(tk, pays, p, cell)
        ref = partition_cuda.partition_cells_ref(tk, pays, p, cell)
        g = [host(t) for t in (got[0], *got[1], got[2], got[3])]
        r = [host(t) for t in (ref[0], *ref[1], ref[2], ref[3])]
        require(all(np.array_equal(a, b) for a, b in zip(g, r)) and bool(got[4]) == bool(ref[4]),
                f"partition kernel != plain: {name}")
        hist = np.bincount(host(wang_hash(tk)) >> np.uint32(bucket_shift(p)), minlength=p)
        require(np.array_equal(r[-1], hist) and bool(ref[4]) == overflow,
                f"plain partition counts or flag: {name}")
        print(f"[partition] {name} (n={len(keys)}, P={p}, cell={cell}, payloads={n_pay}):"
              f" kernel == plain on every lane", flush=True)
        return tk, pays, max(max_err(a, b) for a, b in zip(g, r))

    err = 0
    timed = None
    for p in (8, 2, 16):
        keys = rng.integers(0, 2**32, PART_N, dtype=np.uint32)
        keys[:3] = 0xFFFFFFFF  # an ordinary key here
        tk, pays, e = check(f"random 16Mi P={p}", keys, 1, p, PART_N // p * 2)
        err = max(err, e)
        if p == 8:
            timed = (tk, pays)
    odd = 3 * (1 << 20) + 17
    for n_pay in (0, 3):
        err = max(err, check(f"random {odd}", rng.integers(0, 2**32, odd, dtype=np.uint32),
                             n_pay, 8, odd // 8 * 2)[2])
    one = np.full(odd, 12345, np.uint32)
    err = max(err, check("one bucket", one, 1, 8, odd)[2])
    err = max(err, check("one bucket, overflow", one, 1, 8, 1024, overflow=True)[2])
    err = max(err, check("one bucket, cut-off inside a tile", one, 1, 8,
                         5 * partition_cuda.TILE + 100, overflow=True)[2])
    tile = partition_cuda.TILE
    for n in (1, tile - 1, tile, tile + 1):  # the sweep's tile edges
        err = max(err, check(f"n = {n}", rng.integers(0, 2**32, n, dtype=np.uint32), 1, 4,
                             max(1, n // 2))[2])
    err = max(err, check("P=16, 9 payloads (two launches)",
                         rng.integers(0, 2**32, 5 * tile + 3, dtype=np.uint32), 9, 16, tile)[2])

    # the operators' call at the SF=64 main path's shape: one side's 128Mi
    # keys + 1 payload into P = 2 cells of 128Mi (32768 tiles), no selection
    # plane; compared on the card
    n = SF64 * SF1_ROWS
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    big = [rand_u32(n, gen) for _ in range(2)]
    got = partition_cuda.partition_cells(big[0], big[1:], 2, n, with_sel=False)
    ref = partition_cuda.partition_cells_ref(big[0], big[1:], 2, n, with_sel=False)
    require(got[2] is None and ref[2] is None, "partition with_sel=False returned a selection")
    require(card_equal((got[0], *got[1], got[3]), (ref[0], *ref[1], ref[3]))
            and not bool(got[4]) and not bool(ref[4]), "partition kernel != plain: SF=64 side")
    require(int(ref[3].to(torch.int64).sum()) == n, "plain partition counts: SF=64 side")
    print(f"[partition] one SF=64 side (n={n}, P=2, cell={n}, payloads=1, no selection):"
          " kernel == plain on every lane", flush=True)
    del got, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def timing(label, keys, pays, p, cell, with_sel):
        """Eager and graph-replay readings of the kernel beside a stable
        torch.sort of the bucket, in turns, and its per-launch breakdown."""
        def call():
            return partition_cuda.partition_cells(keys, pays, p, cell, with_sel=with_sel)

        bucket = (wang_hash(keys).to(torch.int64) >> bucket_shift(p)).to(torch.int32)
        lib = library_ms("stable torch.sort of the bucket", lambda: torch.sort(bucket, stable=True))
        require(lib is not None, "stable torch.sort of the bucket did not run")
        eager = interleaved({"kernel": lambda: cuda_ms(call),
                             "lib": lambda: cuda_ms(lambda: torch.sort(bucket, stable=True))})
        graph = interleaved({"kernel": lambda: graph_ms(call),
                             "lib": lambda: graph_ms(lambda: torch.sort(bucket, stable=True))})
        parts = kernel_replay.launch_breakdown(call)
        # keys and payloads read once; key, payload and selection cells
        # (P x cell lanes each, pads included) written once
        n = keys.shape[0]
        nbytes = 4 * n * (1 + len(pays)) + 4 * p * cell * (1 + len(pays) + with_sel)
        print(
            f"[partition] {label} (n={n} P={p} cell={cell} {len(pays)} payload"
            f"{' + selection' if with_sel else ''}): kernel {eager['kernel']:.4f} ms eager,"
            f" {graph['kernel']:.4f} graph; stable torch.sort of the bucket {eager['lib']:.4f}"
            f" eager, {graph['lib']:.4f} graph; bound {bound_ms(nbytes):.4f} ms (median of"
            f" {REPS}, CUDA events, 3 rounds in turns) [{card}]",
            flush=True,
        )
        print(f"[partition] {label} per launch, eager, ms: "
              + "; ".join(f"{k[:60]} {v:.4f}" for k, v in parts.items()) + f" [{card}]",
              flush=True)
        return eager, graph, nbytes, parts

    sf64 = timing("SF=64 side", big[0], big[1:], 2, n, False)
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    tk, pays = timed
    cell = PART_N // 8 * 2
    eager, graph, nbytes, parts = timing("partition_kernel_p8", tk, pays, 8, cell, True)
    # the plain version syncs with the host (bincount): eager only
    plain_ms = cuda_ms(lambda: partition_cuda.partition_cells_ref(tk, pays, 8, cell))
    print(f"[partition] n={PART_N} P=8 cell={cell}: plain {plain_ms:.4f} ms [{card}]", flush=True)
    return {**kernel_row(err, eager["kernel"], plain_ms, nbytes, eager["lib"]),
            "graph_ms": graph["kernel"], "library_graph_ms": graph["lib"], "launch_ms": parts,
            "sf64_side": {"ms": sf64[0]["kernel"], "graph_ms": sf64[1]["kernel"],
                          "library_ms": sf64[0]["lib"], "library_graph_ms": sf64[1]["lib"],
                          "bound_ms": bound_ms(sf64[2]), "launch_ms": sf64[3]}}


def phase_round_kernels(card: str) -> None:
    """sort_bitonic and propagate_fill against their plain versions at one
    SF=64 shuffle round's shape, compared on the card: the keys31 co-sort of
    the round's two 128Mi cell planes (256Mi lanes: the packed key k2 = key
    << 1 | side and one merged payload plane, half of each side's lanes cell
    padding) and the fill of its sorted pk rows' key and payload, built as
    ops/merge.py's _fill_match builds it. Timed once each."""
    import torch

    from dpu_olap_tpu_torch.ops import scan_cuda, sort_cuda
    from dpu_olap_tpu_torch.ops.merge import EMPTY, _u32

    cell = SF64 * SF1_ROWS  # a side's round plane: the round's 128Mi cell
    n, rows = 2 * cell, cell // 2  # co-sort lanes; valid rows a side (slack 2.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device="cuda")

    pk = torch.arange(rows, device="cuda") * 3  # unique keys < 2^31 - 1
    fk = pk[randint(rows, rows)]
    pads = torch.full((cell - rows,), EMPTY, dtype=torch.int64, device="cuda")
    zeros = torch.zeros_like(pads)
    k2 = torch.cat([pk << 1, pads - 1, (fk << 1) | 1, pads])  # pads: 0xFFFFFFFE / 0xFFFFFFFF
    pay = torch.cat([randint(2**32, rows), zeros, randint(2**32, rows), zeros])
    perm = torch.randperm(n, generator=gen, device="cuda")
    planes = (_u32(k2[perm]), _u32(pay[perm]))
    del pk, fk, pads, zeros, k2, pay, perm

    got = sort_cuda.sort_bitonic(planes)
    ref = sort_cuda.sort_bitonic_ref(planes)
    require(bool((ref[0].to(torch.int64).diff() >= 0).all()), "plain sort at the round's shape")
    require(card_equal(got, ref), f"sort kernel != plain at one SF=64 round (n={n}, 1 payload)")
    k2s = got[0].to(torch.int64)
    sk = torch.where(k2s >= 0xFFFFFFFE, EMPTY, k2s >> 1)
    fill = (_u32(torch.where((k2s & 1) == 0, sk, EMPTY)), got[1])
    del k2s, sk, ref
    filled = scan_cuda.propagate_fill(fill)
    require(card_equal(filled, scan_cuda.propagate_fill_ref(fill)),
            f"fill kernel != plain at one SF=64 round (n={n}, key + 1 payload)")
    require(card_equal(filled, scan_cuda.propagate_fill(fill)),
            f"fill kernel: two calls in a row differ at one SF=64 round (n={n})")
    del got, filled
    torch.cuda.synchronize()
    sort_ms = cuda_ms(lambda: sort_cuda.sort_bitonic(planes))
    sort_plain = cuda_ms(lambda: sort_cuda.sort_bitonic_ref(planes))
    fill_ms = cuda_ms(lambda: scan_cuda.propagate_fill(fill))
    fill_plain = cuda_ms(lambda: scan_cuda.propagate_fill_ref(fill))
    work = sort_cuda.radix_plan(n, 1).work_words * 8
    print(
        f"[round] one SF=64 round (n={n}, key + 1 payload): sort kernel == plain on every plane,"
        f" fill kernel == plain, and equal in two calls in a row; sort kernel {sort_ms:.4f} ms, plain {sort_plain:.4f} ms; fill"
        f" kernel {fill_ms:.4f} ms, plain {fill_plain:.4f} ms; bound of each"
        f" {bound_ms(2 * 2 * 4 * n):.4f} ms; the sort's work memory {work} B"
        f" (median of {REPS}, CUDA events) [{card}]",
        flush=True,
    )
    del planes, fill
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_merge_probe_kernel(rng, card: str) -> dict:
    """merge_probe kernel == plain, bit for bit on every lane, on the card,
    with the tiled range merge's edges; timed at 2Mi x 2Mi with one payload,
    eager and as graph replays, beside torch.searchsorted."""
    import torch

    from dpu_olap_tpu_torch.bench import kernel_replay
    from dpu_olap_tpu_torch.ops import merge_cuda
    from dpu_olap_tpu_torch.ops.hashtable import _signed_view

    empty = np.uint32(0xFFFFFFFF)

    def check(name, left, right, n_pay):
        pays = [on_card(rng.integers(0, 2**32, len(right), dtype=np.uint32)) for _ in range(n_pay)]
        tl, tr = on_card(left), on_card(right)
        got = merge_cuda.merge_probe(tl, tr, pays)
        ref = merge_cuda.merge_probe_ref(tl, tr, pays)
        g = [host(t) for t in (got[0], got[1], *got[2])]
        r = [host(t) for t in (ref[0], ref[1], *ref[2])]
        require(all(np.array_equal(a, b) for a, b in zip(g, r)), f"merge_probe kernel != plain: {name}")
        j = np.searchsorted(right, left, side="right") - 1
        require(np.array_equal(r[0], j >= 0) and np.array_equal(
            r[1], np.where(j >= 0, right[np.maximum(j, 0)] if len(right) else empty, empty)),
            f"plain merge_probe keys: {name}")
        print(f"[merge_probe] {name} ({len(left)} x {len(right)}, payloads={n_pay}):"
              f" kernel == plain on every lane", flush=True)
        return tl, tr, pays, max(max_err(a, b) for a, b in zip(g, r))

    def build(n):
        return np.sort(rng.choice(2**31, n, replace=False).astype(np.uint32))

    right = build(PROBE_N)
    left = np.sort(rng.integers(0, 2**31, PROBE_N, dtype=np.uint32))
    tl, tr, pays, err = check("2Mi x 2Mi", left, right, 1)
    timed = (tl, tr, pays)
    small = build(HT_N)
    cases = [
        ("1Mi x 1Mi all present", np.sort(small), small, 1),
        ("repeated keys", np.sort(small[rng.integers(0, HT_N, 3 * HT_N)]), small, 3),
        ("absent and below every key", np.sort(rng.integers(0, 2**31, 3 * 10**6 + 7,
                                                            dtype=np.uint32)), small + 1000, 1),
        ("empty build side", left[:5000], np.zeros(0, np.uint32), 1),
    ]
    tails_l, tails_r = left.copy(), right.copy()
    tails_l[-1000:] = empty
    tails_r[-77:] = empty
    cases.append(("EMPTY tails on both sides", tails_l, tails_r, 3))
    # the tiled range merge's edges: empty and one-key build sides, one probe
    # key, probes much denser and much sparser than the build side (ranges
    # past merge_cuda.STAGE), keys below or above every build key, a run of
    # equal keys over the tile edges, an unsorted probe
    tile = merge_cuda.TILE
    mid = small[HT_N // 2]
    run = np.sort(np.concatenate([left[:tile - 50], np.full(2 * tile + 3, mid, np.uint32)]))
    cases += [
        ("empty build side, no payload", left[:3000], np.zeros(0, np.uint32), 0),
        ("one build key", left[:5000], small[HT_N // 3:HT_N // 3 + 1], 2),
        ("one probe key", small[7:8], small, 1),
        ("probe denser than the build side", left, small[:100], 1),
        ("probe sparser than the build side", np.sort(left[::2048]), right, 1),
        ("every key below the build side", np.sort(small[:5000] // 4096), small + 2**20, 1),
        ("every key above the build side", np.sort(left[:5000] | 2**31), small, 8),
        ("a run of equal keys over tile edges", run, small, 1),
        ("unsorted probe", rng.permutation(left[:5 * tile + 7]), small, 1),
    ]
    for name, lft, rgt, n_pay in cases:
        err = max(err, check(name, lft, rgt, n_pay)[3])
    torch.cuda.synchronize()

    tl, tr, pays = timed
    plain_ms = cuda_ms(lambda: merge_cuda.merge_probe_ref(tl, tr, pays))
    sl, sr = _signed_view(tl), _signed_view(tr)
    require(library_ms("torch.searchsorted", lambda: torch.searchsorted(sr, sl, right=True))
            is not None, "torch.searchsorted did not run")
    j = (torch.searchsorted(sr, sl, right=True) - 1).clamp(min=0)
    r32, p32 = tr.view(torch.int32), pays[0].view(torch.int32)
    # sub-0.1 ms times spread between calls: MP_ROUNDS rounds, each timing
    # the kernel, searchsorted and its two gathers one after another
    times = {"kernel": [], "searchsorted": [], "gathers": []}
    for _ in range(MP_ROUNDS):
        times["kernel"].append(cuda_ms(lambda: merge_cuda.merge_probe(tl, tr, pays)))
        times["searchsorted"].append(cuda_ms(lambda: torch.searchsorted(sr, sl, right=True)))
        times["gathers"].append(cuda_ms(lambda: (r32[j], p32[j])))
    ms, lib = float(np.median(times["kernel"])), float(np.median(times["searchsorted"]))
    lib_total = [s + g for s, g in zip(times["searchsorted"], times["gathers"])]
    faster = sum(k < t for k, t in zip(times["kernel"], lib_total))
    spread = "; ".join(f"{k} min {min(v):.4f} median {np.median(v):.4f} max {max(v):.4f}"
                       for k, v in (*times.items(), ("searchsorted + gathers", lib_total)))
    # probe, build keys and payload read once; has, key, payload written
    nbytes = 4 * PROBE_N + 2 * 4 * PROBE_N + (1 + 4 + 4) * PROBE_N

    graph = interleaved({
        "kernel": lambda: graph10_ms(lambda: merge_cuda.merge_probe(tl, tr, pays)),
        "lib": lambda: graph10_ms(lambda: torch.searchsorted(sr, sl, right=True))})
    parts = kernel_replay.launch_breakdown(lambda: merge_cuda.merge_probe(tl, tr, pays))
    print(
        f"[merge_probe] {PROBE_N} x {PROBE_N} 1 payload: kernel {ms:.4f} ms eager,"
        f" {graph['kernel']:.4f} graph; plain {plain_ms:.4f} ms eager;"
        f" torch.searchsorted(right=True) {lib:.4f} ms eager, {graph['lib']:.4f} graph, + its two"
        f" index gathers {float(np.median(times['gathers'])):.4f} ms; bound"
        f" {bound_ms(nbytes):.4f} ms (eager: medians over {MP_ROUNDS} rounds of a median of"
        f" {REPS}; graph: {GRAPH_CALLS} calls a replay, 3 rounds in turns; CUDA events) [{card}]",
        flush=True,
    )
    print(f"[merge_probe] spread over {MP_ROUNDS} rounds, ms: {spread}; the kernel beat"
          f" searchsorted + gathers in {faster} of {MP_ROUNDS} rounds [{card}]", flush=True)
    print(f"[merge_probe] per launch, eager, ms: "
          + "; ".join(f"{k[:60]} {v:.4f}" for k, v in parts.items()) + f" [{card}]", flush=True)
    return {**kernel_row(err, ms, plain_ms, nbytes, lib), "graph_ms": graph["kernel"],
            "library_graph_ms": graph["lib"], "launch_ms": parts}


def run_path(label: str, make_op, counters: dict, phases, card: str, rows: int,
             absent: dict | None = None, run=None, reps: int = RUN_REPS):
    """Drive one operator path once with its launch counts set to 0 just
    before Run() and read just after (each of ``counters`` must launch, none
    of ``absent``); then time ``reps`` fresh runs. ``run(op)`` replaces
    op.Run() where a path is driven through another entry point. Returns
    (output, launches)."""
    import torch

    absent = absent or {}
    run = run or (lambda o: o.Run())
    op = make_op().Prepare()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (*counters.values(), *absent.values()):
        mod.LAUNCHES = 0
    out = run(op)
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}
    stray = {name: mod.LAUNCHES for name, mod in absent.items() if mod.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    require(
        all(v > 0 for v in launches.values()),
        f"{label}: the path did not launch every kernel: {launches}",
    )
    require(not stray, f"{label}: the path launched kernels of another path: {stray}")
    secs, ph = [], {}
    for _ in range(reps):
        op_t = make_op().Prepare()
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(op_t)
        secs.append(time.perf_counter() - t)
        for name in phases:
            ph.setdefault(name, []).append(op_t.Timers().sum_ms(name))
    run_s = float(np.median(secs))
    phase_ms = {k: round(float(np.median(v)), 3) for k, v in ph.items()}
    print(
        f"[{label}] launches {launches}; Run() {run_s * 1e3:.3f} ms = {rows / run_s:.1f} rows/s"
        f" (median of {reps}; phases ms {phase_ms}); peak device memory {peak} B [{card}]",
        flush=True,
    )
    return out, launches


def host_ms(fn) -> float:
    """Median host-clock time of fn over RUN_REPS runs, the card synchronised
    before each start and after each end."""
    import torch

    times = []
    for _ in range(RUN_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def profile_run(label: str, run, card: str) -> None:
    """One run(), e.g. a prepared operator's Run, under torch.profiler: its
    wall time, the card's busy time (the union of its kernel and copy
    intervals), the idle share, and the device events that took longest in
    all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    require(bool(spans), f"profile {label}: no device events")
    busy_us, end, per = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        per[name] = per.get(name, 0.0) + (e - s) / 1e3
    busy = busy_us / 1e3
    top = "; ".join(f"{n[:60]} {v:.4f}" for n, v in sorted(per.items(), key=lambda kv: -kv[1])[:8])
    print(f"[profile {label}] wall {wall_ms:.3f} ms, device busy {busy:.4f} ms, idle share"
          f" {1 - busy / wall_ms:.4f}; device ms: {top} [{card}]", flush=True)


def result_split(label: str, res, card: str) -> None:
    """gather-result's parts on a join's padded device result: the copy of
    every column to the host, the numpy mask there, against masking on the
    card and copying only the matched rows."""
    import torch

    fk, lcols, rcols, matched = res
    cols = (fk, *lcols, *rcols)
    d2h = host_ms(lambda: [host(c) for c in (matched, *cols)])
    m, hcols = host(matched), [host(c) for c in cols]
    mask = host_ms(lambda: [c[m] for c in hcols])
    dev = host_ms(lambda: [host(c.view(torch.int32)[matched]) for c in cols])
    print(f"[split {label}] {len(cols)} columns of {len(m)} rows, {int(m.sum())} matched:"
          f" D2H {d2h:.3f} ms + numpy mask {mask:.3f} ms, against mask on the card + copy of"
          f" the matched rows {dev:.3f} ms (median of {RUN_REPS}, host clock) [{card}]",
          flush=True)


def phase_join(sf: int, card: str) -> dict:
    import torch

    from dpu_olap_tpu_torch.generator import make_join_tables
    from dpu_olap_tpu_torch.operators.join_op import JoinGpu, JoinNative
    from dpu_olap_tpu_torch.ops import (
        bitonic_cuda, merge, merge_cuda, partition_cuda, scan_cuda, sort_cuda, take_cuda,
    )
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    left, right = make_join_tables(sf, SF1_ROWS, SF1_ROWS, seed=SEED)
    ds = DeviceSet.allocate(1)
    require(JoinGpu(ds, left, right).Prepare().pk_dense, "generator pk not detected dense")
    out, launches = run_path(
        f"join SF={sf}", lambda: JoinGpu(ds, left, right),
        {"sort": sort_cuda, "gather": take_cuda}, JOIN_PHASES, card, left.num_rows,
        absent={"merge": bitonic_cuda, "fill": scan_cuda, "partition": partition_cuda,
                "merge_probe": merge_cuda},
    )
    lc, rc = left.concat(), right.concat()
    if sf == 1:
        nat = JoinNative(left, right).Prepare().Run()
        cols = ("fk", "y", "x")
        require(len(out["fk"]) == nat.num_rows, "SF=1 row count differs from pyarrow")
        require(
            np.array_equal(canon([out[c] for c in cols]), canon([nat[c].to_numpy() for c in cols])),
            "SF=1 JoinGpu != JoinNative",
        )
        truth = "pyarrow"
    else:
        pk0 = int(rc["pk"][0])
        fk_out = out["fk"].astype(np.int64)
        require(len(fk_out) == lc.num_rows, f"SF={sf} row count != left rows")
        require(np.array_equal(out["x"], rc["x"][fk_out - pk0]), f"SF={sf} x != right_x[fk - pk0]")
        require(
            np.array_equal(canon([out["fk"], out["y"]]), canon([lc["fk"], lc["y"]])),
            f"SF={sf} (fk, y) multiset differs from the input",
        )
        truth = "the dense truth"
    # device time of join_shard_dense on device-resident inputs, and of its
    # two kernels alone at the same shapes
    fk, y, pk, x = (on_card(lc["fk"]), on_card(lc["y"]), on_card(rc["pk"]), on_card(rc["x"]))
    total = cuda_ms(lambda: merge.join_shard_dense(fk, (y,), pk, (x,)))
    idx = merge._u32(fk.to(torch.int64) - pk[:1].to(torch.int64))
    s_ms = cuda_ms(lambda: sort_cuda.sort_bitonic((idx, y)))
    sidx = sort_cuda.sort_bitonic((idx, y))[0]
    g_ms = cuda_ms(lambda: take_cuda.gather_sorted(x, sidx))
    g_graph = graph10_ms(lambda: take_cuda.gather_sorted(x, sidx))
    total_graph = graph_ms(lambda: merge.join_shard_dense(fk, (y,), pk, (x,)))
    rows = len(out["fk"])
    print(
        f"[join SF={sf}] {rows} rows == {truth}; device join_shard_dense {total:.4f} ms ="
        f" {rows / (total / 1e3):.1f} rows/s, graph {total_graph:.4f} ms (sort {s_ms:.4f} ms,"
        f" gather {g_ms:.4f} ms eager, {g_graph:.4f} graph; {left.num_rows} rows) [{card}]",
        flush=True,
    )
    return launches


def _tpch_sf1_tables():
    """TPC-H SF=1 key shape from seed 42: orders (o_orderkey: the first 8 of
    every 32 key values, spec §4.2.3; x) and lineitem (1-7 rows per order,
    l_orderkey; y), each one batch."""
    from dpu_olap_tpu_torch.columnar import Batch, Table

    rng = np.random.default_rng(SEED)
    i = np.arange(TPCH_ORDERS, dtype=np.uint32)
    okey = (i // 8) * 32 + i % 8 + 1
    per = rng.integers(1, 8, TPCH_ORDERS)
    lkey = np.repeat(okey, per)
    left = Table([Batch.from_numpy({
        "fk": lkey, "y": rng.integers(0, 2**32, len(lkey), dtype=np.uint32)})])
    right = Table([Batch.from_numpy({
        "pk": okey, "x": rng.integers(0, 2**32, TPCH_ORDERS, dtype=np.uint32)})])
    return left, right


def _permuted_join_tables(top: int):
    """BM_JoinDpu SF=1 tables with the build side's rows permuted (seed 42),
    as a hash-partitioned build side arrives; keys offset by ``top``."""
    from dpu_olap_tpu_torch.columnar import Batch, Table
    from dpu_olap_tpu_torch.generator import make_join_tables

    left, right = make_join_tables(1, SF1_ROWS, SF1_ROWS, seed=SEED)
    lb, rb = left.concat(), right.concat()
    perm = np.random.default_rng(SEED).permutation(rb.num_rows)
    off = np.uint32(top)
    left = Table([Batch.from_numpy({"fk": lb["fk"] + off, "y": lb["y"]})])
    right = Table([Batch.from_numpy({"pk": rb["pk"][perm] + off, "x": rb["x"][perm]})])
    return left, right


def phase_join_fallbacks(card: str) -> dict:
    """JoinGpu on a pk that is not dense: each fallback path once with its
    launch counts zeroed around Run(), against pyarrow."""
    import torch

    from dpu_olap_tpu_torch.operators.join_op import JoinGpu, JoinNative
    from dpu_olap_tpu_torch.ops import (
        bitonic_cuda, join, merge_cuda, partition_cuda, scan_cuda, sort_cuda, take_cuda,
    )
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    ds = DeviceSet.allocate(1)
    others = {"partition": partition_cuda, "merge_probe": merge_cuda}
    paths = [
        ("sorted-build TPC-H SF=1", _tpch_sf1_tables(), (True, True),
         {"sort": sort_cuda, "merge": bitonic_cuda, "fill": scan_cuda}, {"gather": take_cuda}),
        ("fused keys31 SF=1", _permuted_join_tables(0), (True, False),
         {"sort": sort_cuda, "fill": scan_cuda}, {"gather": take_cuda, "merge": bitonic_cuda}),
        ("fused generic SF=1", _permuted_join_tables(0x80000000), (False, False),
         {"fill": scan_cuda}, {"gather": take_cuda, "merge": bitonic_cuda}),
    ]
    total = {"sort": 0, "merge": 0, "fill": 0}
    for label, (left, right), flags, counters, absent in paths:
        op = JoinGpu(ds, left, right).Prepare()
        require((op.keys31, op.pk_sorted, op.pk_dense) == (*flags, False),
                f"{label}: structure flags {(op.keys31, op.pk_sorted, op.pk_dense)}")
        out, launches = run_path(
            f"join {label}", lambda: JoinGpu(ds, left, right), counters, JOIN_PHASES, card,
            left.num_rows, absent={**absent, **others},
        )
        for name, n in launches.items():
            total[name] += n
        nat = JoinNative(left, right).Prepare().Run()
        cols = ("fk", "y", "x")
        require(len(out["fk"]) == nat.num_rows, f"{label}: row count differs from pyarrow")
        require(
            np.array_equal(canon([out[c] for c in cols]), canon([nat[c].to_numpy() for c in cols])),
            f"{label}: JoinGpu != JoinNative",
        )
        lc, rc = left.concat(), right.concat()
        args = (on_card(lc["fk"]), (on_card(lc["y"]),), on_card(rc["pk"]), (on_card(rc["x"]),))
        torch.cuda.synchronize()
        dev_ms = cuda_ms(lambda: join.join_shard_auto(*args, keys31=flags[0], pk_sorted=flags[1]))
        rows = len(out["fk"])
        print(
            f"[join {label}] {left.num_rows} x {right.num_rows} rows -> {rows} rows == pyarrow;"
            f" device join_shard_auto {dev_ms:.4f} ms = {left.num_rows / (dev_ms / 1e3):.1f}"
            f" rows/s [{card}]",
            flush=True,
        )
        result_split(label, join.join_shard_auto(*args, keys31=flags[0], pk_sorted=flags[1]), card)
        profile_run(f"join {label}", JoinGpu(ds, left, right).Prepare().Run, card)
    return total


def phase_filter(sf: int, card: str) -> dict:
    """BM_Filter: SF*128 batches x 64Ki (filter_benchmark.cc:150-158)."""
    from dpu_olap_tpu_torch.generator import make_filter_batches
    from dpu_olap_tpu_torch.operators.filter_op import FilterGpu, FilterNative
    from dpu_olap_tpu_torch.ops import filter as filt
    from dpu_olap_tpu_torch.ops import filter_cuda
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    table = make_filter_batches(sf * 128, 1 << 16, seed=SEED)
    ds = DeviceSet.allocate(1)
    out, launches = run_path(
        f"filter SF={sf}", lambda: FilterGpu(ds, table), {"filter": filter_cuda},
        ("stage", "dispatch", "collect"), card, table.num_rows,
    )
    nat = FilterNative(table).Prepare().Run()
    require(len(out) == len(nat) == len(table), f"filter SF={sf}: chunk count")
    for i, (g, e) in enumerate(zip(out, nat)):
        require(np.array_equal(g, e), f"filter SF={sf}: chunk {i} != pyarrow")
    x = on_card(np.stack([b["a"] for b in table.batches]))
    dev_ms = cuda_ms(lambda: (filt.default_predicate(x).sum(dim=1), filt.filter_compact(x.reshape(-1))))
    kept = sum(len(c) for c in out)
    print(
        f"[filter SF={sf}] {len(out)} chunks, {kept} of {table.num_rows} rows kept == pyarrow;"
        f" device counts + compaction of one round {dev_ms:.4f} ms ="
        f" {table.num_rows / (dev_ms / 1e3):.1f} rows/s [{card}]",
        flush=True,
    )
    return launches


def phase_sum(sf: int, card: str) -> dict:
    """BM_Aggr: SF x 2Mi and SF*32 x 64Ki (aggr_benchmark.cc:146-155)."""
    from dpu_olap_tpu_torch.generator import make_filter_batches
    from dpu_olap_tpu_torch.operators.aggr_op import SumGpu, SumNative
    from dpu_olap_tpu_torch.ops import sum_cuda
    from dpu_olap_tpu_torch.ops.aggregate import sum_u64_pair
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    ds = DeviceSet.allocate(1)
    total = {"sum": 0}
    for nb, rows in ((sf, 1 << 21), (sf * 32, 1 << 16)):
        table = make_filter_batches(nb, rows, seed=SEED)
        label = f"sum SF={sf} {nb}x{rows}"
        got, launches = run_path(
            label, lambda: SumGpu(ds, table), {"sum": sum_cuda},
            ("stage", "dispatch", "collect"), card, table.num_rows,
        )
        expect = SumNative(table).Prepare().Run()
        require(isinstance(got, int) and got == expect, f"{label}: {got} != pyarrow {expect}")
        x = on_card(np.concatenate([b["a"] for b in table.batches]))
        dev_ms = cuda_ms(lambda: sum_u64_pair(x))
        print(
            f"[{label}] {got} == pyarrow; device sum of one round {dev_ms:.4f} ms ="
            f" {table.num_rows / (dev_ms / 1e3):.1f} rows/s [{card}]",
            flush=True,
        )
        total["sum"] += launches["sum"]
    return total


def phase_take(sf: int, card: str) -> dict:
    """BM_Take: SF x 4Mi data / 512Ki indices (take_benchmark.cc:155-164)."""
    from dpu_olap_tpu_torch.generator import make_take_batches
    from dpu_olap_tpu_torch.operators.take_op import TakeGpu, TakeNative
    from dpu_olap_tpu_torch.ops import sort_cuda, take_cuda
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    data, idx = make_take_batches(sf, 1 << 22, 1 << 19, seed=SEED)
    ds = DeviceSet.allocate(1)
    require(TakeGpu(ds, data, idx).Prepare()._use_sorted, "TakeGpu did not pick the sorted path")
    out, launches = run_path(
        f"take SF={sf}", lambda: TakeGpu(ds, data, idx),
        {"sort": sort_cuda, "gather": take_cuda},
        ("stage", "dispatch", "collect"), card, idx.num_rows,
    )
    nat = TakeNative(data, idx).Prepare().Run()
    require(len(out) == len(nat) == sf, f"take SF={sf}: batch count")
    for i, (g, e) in enumerate(zip(out, nat)):
        require(np.array_equal(g, e), f"take SF={sf}: batch {i} != pyarrow")
    op = TakeGpu(ds, data, idx).Prepare()
    d = on_card(np.stack([b["a"] for b in data.batches]))
    q = on_card(np.stack([b["i"] for b in idx.batches]))
    dev_ms = cuda_ms(lambda: op._take_round(d, q))
    print(
        f"[take SF={sf}] {idx.num_rows} queries into {data.num_rows} rows == pyarrow;"
        f" device take of one round {dev_ms:.4f} ms = {idx.num_rows / (dev_ms / 1e3):.1f} rows/s"
        f" [{card}]",
        flush=True,
    )
    return launches


def packed_rows(fk, y) -> np.ndarray:
    """(fk, y) pairs packed into uint64: one sort key for a row multiset."""
    return (np.asarray(fk).astype(np.uint64) << np.uint64(32)) | np.asarray(y).astype(np.uint64)


def check_rows(label: str, out, fk, y, x) -> None:
    """out's (fk, y, x) rows equal the given rows as multisets: both sorted
    by the packed (fk, y) pair (an argsort, seconds at 16Mi rows where a
    lexsort of three columns takes far longer); x follows, pk being unique."""
    require(len(out["fk"]) == len(fk), f"{label}: {len(out['fk'])} rows, expected {len(fk)}")
    a, b = packed_rows(out["fk"], out["y"]), packed_rows(fk, y)
    oa, ob = np.argsort(a), np.argsort(b)
    require(np.array_equal(a[oa], b[ob]), f"{label}: (fk, y) rows differ")
    require(np.array_equal(np.asarray(out["x"])[oa], np.asarray(x)[ob]), f"{label}: x differs")


def check_dense_truth(label: str, out, lc, rc) -> None:
    """A BM_JoinDpu join result against the dense truth: every left row
    once, with x = right_x[fk - pk0]; the (fk, y) multisets compared by a
    sort of the packed pair."""
    pk0 = int(rc["pk"][0])
    fk_out = out["fk"].astype(np.int64)
    require(len(fk_out) == lc.num_rows, f"{label}: {len(fk_out)} rows != {lc.num_rows} left rows")
    require(np.array_equal(out["x"], rc["x"][fk_out - pk0]), f"{label}: x != right_x[fk - pk0]")
    require(np.array_equal(np.sort(packed_rows(out["fk"], out["y"])),
                           np.sort(packed_rows(lc["fk"], lc["y"]))),
            f"{label}: (fk, y) multiset differs from the input")


def _join_kernels():
    from dpu_olap_tpu_torch.ops import (
        bitonic_cuda, merge_cuda, partition_cuda, scan_cuda, sort_cuda, take_cuda,
    )

    return {"partition": partition_cuda, "sort": sort_cuda, "fill": scan_cuda,
            "gather": take_cuda, "merge": bitonic_cuda, "merge_probe": merge_cuda}


def _split(kernels: dict, names) -> tuple:
    """(counters, absent): the named kernels and all the others."""
    return ({k: m for k, m in kernels.items() if k in names},
            {k: m for k, m in kernels.items() if k not in names})


def phase_join_shuffle_sf64(card: str) -> dict:
    """The slice's main path: JoinGpu on BM_JoinDpu at SF=64, 128Mi rows a
    side, above one round's budget (SINGLE_ROUND_ROWS): _run_any routes it
    to the shuffle join in two resident rounds, which launches the partition
    kernel once per side and the sort and fill kernels once per round.
    Checked against the dense truth; one counted and one timed Run()."""
    from dpu_olap_tpu_torch.generator import make_join_tables
    from dpu_olap_tpu_torch.operators.join_op import JoinGpu
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    t0 = time.perf_counter()
    left, right = make_join_tables(SF64, SF1_ROWS, SF1_ROWS, seed=SEED)
    ds = DeviceSet.allocate(1)
    op = JoinGpu(ds, left, right).Prepare()
    rows = max(left.num_rows, right.num_rows)
    require(op.keys31 and op.pk_dense, "SF=64: structure flags")
    require(op.SINGLE_ROUND_ROWS < rows <= op.MAX_RESIDENT_ROWS and op._ici_rounds() == 2,
            f"SF=64: {rows} rows do not route to the shuffle join in 2 rounds")
    print(f"[join SF={SF64} shuffle] tables and Prepare() {time.perf_counter() - t0:.1f} s",
          flush=True)
    counters, absent = _split(_join_kernels(), ("partition", "sort", "fill"))
    out, launches = run_path(
        f"join SF={SF64} shuffle", lambda: JoinGpu(ds, left, right), counters, JOIN_PHASES, card,
        left.num_rows, absent=absent, reps=1,
    )
    require(launches == {"partition": 2, "sort": 2, "fill": 2},
            f"SF=64: not the two-round shuffle join (one partition per side, one sort and"
            f" fill per round): {launches}")
    t0 = time.perf_counter()
    check_dense_truth(f"SF={SF64} shuffle", out, left.concat(), right.concat())
    print(f"[join SF={SF64} shuffle] {len(out['fk'])} rows == the dense truth"
          f" (check {time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
    return launches


def phase_join_shuffle_sf8(card: str) -> dict:
    """JoinGpu._run_ici(rounds=2) at SF=8 against pyarrow, with a profile;
    impl="sort" at SF=1 through _run_any (the shuffle join in one round)
    against pyarrow."""
    from dpu_olap_tpu_torch.generator import make_join_tables
    from dpu_olap_tpu_torch.operators.join_op import JoinGpu, JoinNative
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    ds = DeviceSet.allocate(1)
    left, right = make_join_tables(SF8, SF1_ROWS, SF1_ROWS, seed=SEED)
    counters, absent = _split(_join_kernels(), ("partition", "sort", "fill"))
    label = f"join SF={SF8} _run_ici(rounds=2)"
    out, launches = run_path(label, lambda: JoinGpu(ds, left, right), counters, JOIN_PHASES, card,
                             left.num_rows, absent=absent, run=lambda o: o._run_ici(rounds=2))
    require(launches == {"partition": 2, "sort": 2, "fill": 2}, f"{label}: launches {launches}")
    nat = JoinNative(left, right).Prepare().Run()
    check_rows(label, out, *(nat[c].to_numpy() for c in ("fk", "y", "x")))
    print(f"[{label}] {len(out['fk'])} rows == pyarrow [{card}]", flush=True)
    op = JoinGpu(ds, left, right).Prepare()
    profile_run(label, lambda: op._run_ici(rounds=2), card)

    # impl="sort": _run_any routes to the shuffle join with rounds = 1, one
    # partition (no partition kernel below P = 2, as in the JAX package) and
    # the sort + searchsorted probe of join_shard
    left, right = make_join_tables(1, SF1_ROWS, SF1_ROWS, seed=SEED)
    op = JoinGpu(ds, left, right, impl="sort").Prepare()
    require(op._ici_rounds() == 1, "impl=sort SF=1: rounds")
    label = "join SF=1 impl=sort"
    out, sort_launches = run_path(label, lambda: JoinGpu(ds, left, right, impl="sort"), {},
                                  JOIN_PHASES, card, left.num_rows, absent=_join_kernels())
    nat = JoinNative(left, right).Prepare().Run()
    check_rows(label, out, *(nat[c].to_numpy() for c in ("fk", "y", "x")))
    print(f"[{label}] {len(out['fk'])} rows == pyarrow through _run_ici, rounds 1 [{card}]",
          flush=True)
    return launches


def phase_join_partitioned_sf8(card: str) -> dict:
    """JoinGpu's host-staged partitioned path at SF=8 (MAX_RESIDENT_ROWS
    shrunk on the instance): 8 partitions of the 8 batches a side, the
    partition kernel once per batch and side, the fused join once per
    partition. Checked against the dense truth."""
    from dpu_olap_tpu_torch.generator import make_join_tables
    from dpu_olap_tpu_torch.operators.join_op import JoinGpu
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    ds = DeviceSet.allocate(1)
    left, right = make_join_tables(SF8, SF1_ROWS, SF1_ROWS, seed=SEED)

    def make():
        op = JoinGpu(ds, left, right)
        op.MAX_RESIDENT_ROWS = 1 << 10  # everything "too big"
        return op

    counters, absent = _split(_join_kernels(), ("partition", "sort", "fill"))
    label = f"join SF={SF8} partitioned"
    out, launches = run_path(label, make, counters, PART_PHASES, card, left.num_rows,
                             absent=absent)
    require(launches == {"partition": 2 * SF8, "sort": SF8, "fill": SF8},
            f"{label}: launches {launches}")
    check_dense_truth(label, out, left.concat(), right.concat())
    print(f"[{label}] {len(out['fk'])} rows == the dense truth [{card}]", flush=True)
    return launches


def phase_partition_sf8(card: str) -> dict:
    """PartitionGpu on the BM_JoinDpu SF=8 probe table (JoinDpu's Phase A
    input, join_dpu.cc:82-142): fk keyed, y carried, 16 partitions; the
    resident engine (one launch) and the host-staged one (one per batch),
    each exactly against a numpy oracle."""
    from dpu_olap_tpu_torch.generator import make_join_tables
    from dpu_olap_tpu_torch.operators import PartitionGpu
    from dpu_olap_tpu_torch.ops.hashing import bucket_shift, wang_hash_np
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    p = 16
    ds = DeviceSet.allocate(1)
    left, _ = make_join_tables(SF8, SF1_ROWS, SF1_ROWS, seed=SEED)
    lc = left.concat()
    b = wang_hash_np(lc["fk"]) >> np.uint32(bucket_shift(p))
    order = np.argsort(b, kind="stable")
    ends = np.cumsum(np.bincount(b, minlength=p))
    oracle = [{c: lc[c][order[e - n:e]] for c in ("fk", "y")}
              for n, e in zip(np.bincount(b, minlength=p), ends)]

    def check(label, parts):
        require(len(parts) == p, f"{label}: {len(parts)} partitions")
        for q, (got, want) in enumerate(zip(parts, oracle)):
            require(all(np.array_equal(got[c], want[c]) for c in ("fk", "y")),
                    f"{label}: partition {q} != the numpy oracle")

    counters, absent = _split(_join_kernels(), ("partition",))
    total = {"partition": 0}
    for resident, n_launch, phases in ((True, 1, ("partition-resident",)),
                                       (False, SF8, ("stage", "dispatch", "collect"))):
        label = f"partition SF={SF8} {'resident' if resident else 'host-staged'}"
        out, launches = run_path(label, lambda: PartitionGpu(ds, left, "fk", p, resident=resident),
                                 counters, phases, card, left.num_rows, absent=absent)
        require(launches == {"partition": n_launch}, f"{label}: launches {launches}")
        check(label, out.to_host() if resident else out)
        print(f"[{label}] {p} partitions == the numpy oracle [{card}]", flush=True)
        total["partition"] += launches["partition"]
    return total


def phase_hashtable(card: str) -> dict:
    """The sorted-store hash table on the hashtable micro's inputs
    (run_benchmarks.py:177-227): 1Mi unique keys from a seed-42 permutation
    of 4Mi, random values. Build (sort kernel), probe of every key and of
    1Mi queries half absent (sort, merge-probe, sort), and the order-free
    stream probe, against numpy; device times of each."""
    import torch

    from dpu_olap_tpu_torch.ops.hashtable import (
        ht_build_sorted, ht_probe_sorted, ht_probe_sorted_stream,
    )

    n = HT_N
    rng = np.random.default_rng(SEED)
    keys = rng.permutation(np.uint32(4 * n))[:n].astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    queries = np.concatenate([keys[rng.integers(0, n, n // 2)],
                              rng.integers(4 * n, 2**32 - 1, n // 2, dtype=np.uint32)])
    rng.shuffle(queries)
    tk, tv, tq = on_card(keys), on_card(vals), on_card(queries)
    counters, absent = _split(_join_kernels(), ("sort", "merge_probe"))
    torch.cuda.synchronize()
    for mod in (*counters.values(), *absent.values()):
        mod.LAUNCHES = 0
    table = ht_build_sorted(tk, tv)
    got_all, found_all = ht_probe_sorted(table, tk)
    got_q, found_q = ht_probe_sorted(table, tq)
    pos, got_s, found_s = ht_probe_sorted_stream(table, tq)
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES for k, m in counters.items()}
    stray = {k: m.LAUNCHES for k, m in absent.items() if m.LAUNCHES}
    require(launches == {"sort": 6, "merge_probe": 3} and not stray,
            f"hashtable: launches {launches}, stray {stray}")
    order = np.argsort(keys)
    sk, sv = keys[order], vals[order]
    require(np.array_equal(host(table.keys), sk) and np.array_equal(host(table.values), sv),
            "hashtable: the sorted store")
    require(host(found_all).all() and np.array_equal(host(got_all), vals), "hashtable: probe of every key")
    j = np.minimum(np.searchsorted(sk, queries), n - 1)
    hit = sk[j] == queries
    want = np.where(hit, sv[j], 0).astype(np.uint32)
    require(np.array_equal(host(found_q), hit) and np.array_equal(host(got_q), want),
            "hashtable: probe of half-absent queries")
    pos_h = host(pos)
    require(pos_h.shape == (n,) and np.array_equal(np.sort(pos_h), np.arange(n)),
            "hashtable: stream positions")
    sv_h, sf_h = np.zeros(n, np.uint32), np.zeros(n, bool)
    sv_h[pos_h], sf_h[pos_h] = host(got_s), host(found_s)
    require(np.array_equal(sf_h, hit) and np.array_equal(sv_h, want), "hashtable: stream probe")
    build_ms = cuda_ms(lambda: ht_build_sorted(tk, tv))
    probe_ms = cuda_ms(lambda: ht_probe_sorted(table, tk))
    mix_ms = cuda_ms(lambda: ht_probe_sorted(table, tq))
    stream_ms = cuda_ms(lambda: ht_probe_sorted_stream(table, tq))
    print(
        f"[hashtable] {n} keys: launches {launches}; == numpy (build, probe of every key, half"
        f" absent, stream as a set on pos); device ms build {build_ms:.4f}, probe {probe_ms:.4f},"
        f" probe half absent {mix_ms:.4f}, stream {stream_ms:.4f} = {n / (probe_ms / 1e3):.1f}"
        f" probes/s (median of {REPS}, CUDA events) [{card}]",
        flush=True,
    )
    return launches


# ---- the host runtime and the query plan ----------------------------------

NATIVE_COPY_BYTES = 1 << 30  # parallel_memcpy's reading: 1 GiB
PLAN_PARTS = 16  # Repartition's partitions (BM_JoinDpu SF=8 probe table)
TRACE_N = 1 << 20  # the ENABLE_TRACE subprocess's filter: 256 tiles


def _host_gbs(nbytes: int, fn) -> float:
    """GB/s of fn moving nbytes: the median of RUN_REPS runs, host clock."""
    times = []
    for _ in range(RUN_REPS):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return nbytes / float(np.median(times)) / 1e9


def _part_rows(parts) -> list:
    """Each partition's (fk, y) rows after a canonical sort."""
    return [np.sort(packed_rows(p["fk"], p["y"])) for p in parts]


def phase_native(card: str) -> None:
    """The port's native runtime against its plain versions: parallel_memcpy
    of 1 GiB against np.copyto, parallel_stack of BM_Filter SF=8's 1024
    batches of 64Ki against np.stack (byte for byte, GB/s beside each), and
    the host-staged Partitioner (slabs + executor) at SF=8 into 16
    partitions against the resident engine's partitions, row sets equal."""
    from dpu_olap_tpu_torch import native
    from dpu_olap_tpu_torch.generator import make_filter_batches, make_join_tables
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet
    from dpu_olap_tpu_torch.parallel.partitioner import Partitioner, ResidentPartitioner

    n = NATIVE_COPY_BYTES // 4
    src = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
    dst, ref = np.zeros_like(src), np.zeros_like(src)
    fast = _host_gbs(src.nbytes, lambda: native.parallel_memcpy(dst, src))
    plain = _host_gbs(src.nbytes, lambda: np.copyto(ref, src))
    require(np.array_equal(dst.view(np.uint8), ref.view(np.uint8)),
            "parallel_memcpy != np.copyto")
    del src, dst, ref
    rows = [b["a"] for b in make_filter_batches(SF8 * 128, 1 << 16, seed=SEED).batches]
    nbytes = sum(r.nbytes for r in rows)
    stack_fast = _host_gbs(nbytes, lambda: native.parallel_stack(rows))
    stack_plain = _host_gbs(nbytes, lambda: np.stack(rows))
    require(np.array_equal(native.parallel_stack(rows), np.stack(rows)),
            "parallel_stack != np.stack")
    print(f"[native] parallel_memcpy of {NATIVE_COPY_BYTES} B {fast:.3f} GB/s, np.copyto"
          f" {plain:.3f} GB/s; parallel_stack of {len(rows)} x {rows[0].size} uint32"
          f" {stack_fast:.3f} GB/s, np.stack {stack_plain:.3f} GB/s; byte for byte equal"
          f" (median of {RUN_REPS}, host clock) [{card}]", flush=True)
    ds = DeviceSet.allocate(1)
    left, _ = make_join_tables(SF8, SF1_ROWS, SF1_ROWS, seed=SEED)
    t = time.perf_counter()
    staged = Partitioner(ds, PLAN_PARTS).partition_table(left, "fk", ["y"])
    staged_s = time.perf_counter() - t
    resident = ResidentPartitioner(ds, PLAN_PARTS).partition_table(left, "fk", ["y"]).to_host()
    require(len(staged) == len(resident) == PLAN_PARTS, "Partitioner: partition count")
    for q, (a, b) in enumerate(zip(_part_rows(staged), _part_rows(resident))):
        require(np.array_equal(a, b), f"Partitioner partition {q} != ResidentPartitioner's")
    print(f"[native] Partitioner at SF={SF8} ({left.num_rows} rows, {PLAN_PARTS} partitions)"
          f" through slabs == ResidentPartitioner after a canonical sort; {staged_s * 1e3:.3f}"
          f" ms [{card}]", flush=True)


def _plan_kernels():
    from dpu_olap_tpu_torch.ops import filter_cuda, sum_cuda

    return {**_join_kernels(), "filter": filter_cuda, "sum": sum_cuda}


def plan_chain(label: str, run, names, rows: int, check, card: str) -> dict:
    """Run one plan chain with every kernel's launch count set to 0 just
    before and read just after (each kernel of ``names`` must launch, no
    other); check its result; time RUN_REPS fresh runs. Prints the chain's
    Counters line (Run() and its Timers() phases) and returns the
    launches."""
    import torch

    from dpu_olap_tpu_torch.metrics import Counters
    from dpu_olap_tpu_torch.timer import Timers, timed

    counters, absent = _split(_plan_kernels(), names)
    torch.cuda.synchronize()
    for mod in (*counters.values(), *absent.values()):
        mod.LAUNCHES = 0
    out = run()
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES for k, m in counters.items()}
    stray = {k: m.LAUNCHES for k, m in absent.items() if m.LAUNCHES}
    require(all(v > 0 for v in launches.values()),
            f"{label}: the chain did not launch every kernel: {launches}")
    require(not stray, f"{label}: the chain launched kernels of another path: {stray}")
    timers = Timers()
    with timed(timers, "check"):
        truth = check(out)
    secs = []
    for r in range(RUN_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with timed(timers, "run", r):
            run()
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    run_s = float(np.median(secs))
    c = Counters(f"plan {label}").items_processed(rows, run_s).timers(timers, ["run", "check"])
    for k, v in launches.items():
        c.set(f"launches_{k}", v)
    c.emit()
    print(f"[plan {label}] launches {launches}; == {truth}; run {run_s * 1e3:.3f} ms ="
          f" {rows / run_s:.1f} rows/s (median of {RUN_REPS}) [{card}]", flush=True)
    return launches


def _filtered(left):
    """BM_JoinDpu's left side filtered by y < 2^30 (one host batch)."""
    from dpu_olap_tpu_torch.columnar import Batch, Table

    lc = left.concat()
    keep = lc["y"] < np.uint32(1 << 30)
    return Table([Batch.from_numpy({"fk": lc["fk"][keep], "y": lc["y"][keep]})])


def phase_plan(card: str) -> dict:
    """The query plan's chains at the reference's published shapes, each
    against pyarrow or numpy (rows after a canonical sort), with its
    kernels' launches counted around one execution."""
    import tempfile

    import torch

    from dpu_olap_tpu_torch import metrics
    from dpu_olap_tpu_torch import plan as P
    from dpu_olap_tpu_torch.generator import (
        make_filter_batches, make_join_tables, make_take_batches,
    )
    from dpu_olap_tpu_torch.operators import aggr_op, join_op
    from dpu_olap_tpu_torch.operators.filter_op import FilterNative
    from dpu_olap_tpu_torch.operators.join_op import JoinNative
    from dpu_olap_tpu_torch.ops.hashing import bucket_shift, wang_hash_np
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    ds = DeviceSet.allocate(1)
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def u64_sum(a) -> int:
        return int(np.asarray(a).astype(np.uint64).sum())

    # Source -> Filter -> Aggregate: the streaming tier (Filter.execute
    # never runs) at SF=1 and SF=8; SF=1 again under metrics.trace
    orig_execute = P.Filter.execute

    def no_materialize(self, ds_):
        raise SmokeFailure("Filter.execute ran: the streaming tier did not")

    for sf in (1, SF8):
        table = make_filter_batches(sf * 128, 1 << 16, seed=SEED)
        want = sum(u64_sum(a[a < np.uint32(1 << 30)]) for a in (b["a"] for b in table))
        P.Filter.execute = no_materialize
        try:
            add(plan_chain(f"Aggregate(Filter(Source)) SF={sf}",
                           lambda t=table: P.Aggregate(P.Filter(P.Source(t), "a"), "a").scalar(ds),
                           ("sum",), table.num_rows,
                           lambda got, w=want: require(got == w, f"{got} != numpy {w}") or "numpy",
                           card))
            if sf == 1:
                scope = "plan_aggregate_filter_sf1"
                with tempfile.TemporaryDirectory() as tmp:
                    with metrics.trace(scope, trace_dir=tmp) as path:
                        got = P.Aggregate(P.Filter(P.Source(table), "a"), "a").scalar(ds)
                    events = json.loads(open(path).read())["traceEvents"]
                require(got == want, "traced chain: wrong sum")
                names = {e.get("name") for e in events}
                kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
                require(scope in names, f"the Chrome trace does not name the scope {scope}")
                require(bool(kernels), "the Chrome trace holds no CUDA kernel")
                print(f"[plan trace] {scope}: Chrome trace of {len(events)} events names the"
                      f" scope and {len(kernels)} CUDA kernels (e.g."
                      f" {kernels[0]['name'][:60]}) [{card}]", flush=True)
        finally:
            P.Filter.execute = orig_execute

    # the materialized Filter at SF=1, batch by batch against pyarrow
    table = make_filter_batches(128, 1 << 16, seed=SEED)
    nat = FilterNative(table).Prepare().Run()

    def check_filter(out):
        require(out.is_device and len(out) == len(nat), "Filter: not one device batch a batch")
        for i, (b, e) in enumerate(zip(out, nat)):
            require(np.array_equal(host(b["a"]), e), f"Filter: batch {i} != pyarrow")
        return "pyarrow"

    add(plan_chain("Filter(Source) SF=1", lambda: P.Filter(P.Source(table), "a").execute(ds),
                   ("filter",), table.num_rows, check_filter, card))

    # the joins on BM_JoinDpu SF=1
    left, right = make_join_tables(1, SF1_ROWS, SF1_ROWS, seed=SEED)
    cols = ("fk", "y", "x")
    truth_f = JoinNative(_filtered(left), right).Prepare().Run()
    truth_f_rows = canon([truth_f[c].to_numpy() for c in cols])
    truth_f_sum = u64_sum(truth_f["x"].to_numpy())
    truth = JoinNative(left, right).Prepare().Run()

    def rows_equal(t, want_rows, what):
        t = t.to_host().concat()
        require(list(t.names) == list(cols), f"{what}: columns {t.names}")
        require(np.array_equal(canon([t[c] for c in cols]), want_rows), f"{what} != pyarrow")
        return "pyarrow"

    add(plan_chain("HashJoin(Filter, Source) SF=1 fused",
                   lambda: P.HashJoin(P.Filter(P.Source(left), "y"), P.Source(right)).execute(ds),
                   ("sort", "fill"), left.num_rows,
                   lambda t: rows_equal(t, truth_f_rows, "fused join"), card))
    add(plan_chain("Aggregate(HashJoin(Filter, Source)) SF=1",
                   lambda: P.Aggregate(P.HashJoin(P.Filter(P.Source(left), "y"), P.Source(right)),
                                       "x").scalar(ds),
                   ("sort", "fill", "sum"), left.num_rows,
                   lambda got: require(got == truth_f_sum, f"{got} != {truth_f_sum}") or "pyarrow",
                   card))
    add(plan_chain("HashJoin(Source, Source) SF=1 dense",
                   lambda: P.HashJoin(P.Source(left), P.Source(right)).execute(ds),
                   ("sort", "gather"), left.num_rows,
                   lambda t: rows_equal(t, canon([truth[c].to_numpy() for c in cols]), "bare join"),
                   card))

    # the device-resident chain: a materialized Filter, the join on its
    # device columns, the sum in place; no JoinGpu, no SumGpu
    class Boom:
        def __init__(self, *a, **k):
            raise SmokeFailure("a materializing operator ran in the device chain")

    def device_chain():
        fnode = P.Filter(P.Source(left), "y")
        ftab = fnode._run(ds)
        jnode = P.HashJoin(fnode, P.Source(right))
        jtab = jnode._run(ds)
        return P.Aggregate(jnode, "x").scalar(ds), ftab, jtab

    def check_chain(out):
        got, ftab, jtab = out
        for what, t in (("Filter", ftab), ("HashJoin", jtab)):
            require(t.is_device and all(c.device.type == "cuda" for b in t for c in b.columns.values()),
                    f"device chain: the {what} output is not on the card")
        require(got == truth_f_sum, f"device chain: {got} != {truth_f_sum}")
        return rows_equal(jtab, truth_f_rows, "device chain join")

    saved = join_op.JoinGpu, aggr_op.SumGpu
    join_op.JoinGpu = aggr_op.SumGpu = Boom
    try:
        add(plan_chain("Filter -> HashJoin -> Aggregate SF=1 device-resident", device_chain,
                       ("filter", "sort", "merge", "fill", "sum"), left.num_rows, check_chain,
                       card))
    finally:
        join_op.JoinGpu, aggr_op.SumGpu = saved

    # Take -> Sum, the order-free tier, on BM_Take SF=1
    data, idx = make_take_batches(1, 1 << 22, 1 << 19, seed=SEED)
    want = sum(u64_sum(d["a"][q["i"]]) for d, q in zip(data, idx))
    add(plan_chain("Aggregate(TakeNode) SF=1",
                   lambda: P.Aggregate(P.TakeNode(P.Source(data), P.Source(idx)), "a").scalar(ds),
                   ("sort", "gather", "sum"), idx.num_rows,
                   lambda got: require(got == want, f"{got} != numpy {want}") or "numpy", card))

    # Repartition of the BM_JoinDpu SF=8 probe table into 16 partitions
    left8, _ = make_join_tables(SF8, SF1_ROWS, SF1_ROWS, seed=SEED)
    lc = left8.concat()
    bucket = wang_hash_np(lc["fk"]) >> np.uint32(bucket_shift(PLAN_PARTS))
    oracle = _part_rows([{c: lc[c][bucket == q] for c in ("fk", "y")} for q in range(PLAN_PARTS)])

    def check_parts(out):
        require(len(out) == PLAN_PARTS, f"Repartition: {len(out)} partitions")
        for q, got in enumerate(_part_rows(out)):
            require(np.array_equal(got, oracle[q]), f"Repartition: partition {q} != the numpy oracle")
        return "numpy"

    add(plan_chain(f"Repartition SF={SF8} P={PLAN_PARTS}",
                   lambda: P.Repartition(P.Source(left8), "fk", PLAN_PARTS).execute(ds),
                   ("partition",), left8.num_rows, check_parts, card))
    torch.cuda.synchronize()
    return total


# ---- the operator suite and the entry points beside it --------------------

# run_benchmarks' entries a group at a time, each group with the kernels it
# must launch (the cuckoo table, the row gather and the memcpy rows run
# none of them)
SUITE_GROUPS = (
    ("^filter_(tpu|native)$", ("filter",)),
    ("^sum_(tpu|native)", ("sum",)),
    ("^take_(tpu|native)", ("sort", "gather")),
    ("^hashtable_", ("sort", "merge_probe")),
    ("^partition_", ("partition",)),
    ("^plan_", ("filter", "sum", "sort", "merge", "fill", "gather")),
    ("^(filter|sum|take|take_rowgather|join)_kernel", ("filter", "sum", "sort", "gather", "merge",
                                                        "fill")),
    ("^parallel_memcpy_", ()),
    ("^join_(tpu|native)", ("sort", "gather")),
)
PHASE_KEYS = ["fragments-ms", "exchange-ms", "local-join-ms"]


def _quiet(fn, *args):
    """fn(*args) with its standard output captured: (result, lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, buf.getvalue().splitlines()


def phase_suite(card: str) -> dict:
    """The port's operator suite (python -m dpu_olap_tpu_torch.bench.
    run_benchmarks) at SF=1, a group of entries at a time with every
    kernel's launch count set to 0 just before and read just after (each
    group must launch the kernels named for it in SUITE_GROUPS), one
    ``[suite]`` line a row; the join row once more with FLAGS.join_timers on
    the shuffle route (impl="sort"), which must carry the three phase_ms
    keys, and the shuffle join of the SF=64 path (cosort, two resident
    rounds) at SF=8 with the same timers; then verify_parity with
    REFERENCE_SHAPES=1 at SF=1, bench_streaming --op filter --sf 1 2 and
    devicecount, each run in this process and required to return 0."""
    import os
    import tempfile
    from unittest import mock

    import torch

    from dpu_olap_tpu_torch.bench import bench_streaming, devicecount, verify_parity
    from dpu_olap_tpu_torch.bench import run_benchmarks as rb
    from dpu_olap_tpu_torch.config import FLAGS
    from dpu_olap_tpu_torch.generator import make_join_tables
    from dpu_olap_tpu_torch.operators.join_op import JoinGpu
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    kernels = _plan_kernels()
    total = dict.fromkeys(kernels, 0)
    names = []

    def group(pattern, need, **kw):
        torch.cuda.synchronize()
        for mod in kernels.values():
            mod.LAUNCHES = 0
        rows, _ = _quiet(rb.run, pattern, 1, 16, "chip_smoke", kw.get("join_impl", "cosort"))
        torch.cuda.synchronize()
        launches = {k: m.LAUNCHES for k, m in kernels.items()}
        require(rows, f"suite {pattern}: no row")
        require(all(launches[k] > 0 for k in need),
                f"suite {pattern}: the entries did not launch {need}: {launches}")
        for r in rows:
            require(r["backend"] == "cuda" and r["items_per_s"] > 0 and "spread_pct" in r
                    and (r["name"] not in rb.STEPS or r["glue_ms"] > 0),
                    f"suite {r['name']}: row {r}")
            print(f"[suite] {json.dumps(r)} [{card}]", flush=True)
        print(f"[suite] {pattern}: launches {launches} [{card}]", flush=True)
        for k, v in launches.items():
            total[k] += v
        return rows

    for pattern, need in SUITE_GROUPS:
        names += [r["name"] for r in group(pattern, need)]
    missing = [n for n in rb.ENTRIES if n not in names]
    require(not missing, f"suite: no row for {missing}")
    require(len(names) == len(set(names)), f"suite: a row twice in {names}")

    FLAGS.join_timers = True
    try:
        # impl="sort" at SF=1 takes the shuffle join in one round: one
        # partition (no partition kernel below P = 2) and the sort probe
        (row,) = group("^join_tpu$", (), join_impl="sort")
        require(all(k in row for k in PHASE_KEYS), f"suite join_tpu timers: {row}")
        # the SF=64 path's shuffle join (cosort, two resident rounds) at SF=8
        left, right = make_join_tables(SF8, SF1_ROWS, SF1_ROWS, seed=SEED)
        op = JoinGpu(DeviceSet.allocate(1), left, right).Prepare()
        for mod in kernels.values():
            mod.LAUNCHES = 0
        op._run_ici(rounds=2)
        torch.cuda.synchronize()
        launches = {k: m.LAUNCHES for k, m in kernels.items()}
        require(list(getattr(op, "phase_ms", {})) == PHASE_KEYS,
                f"join SF={SF8} _run_ici(rounds=2) timers: {getattr(op, 'phase_ms', None)}")
        require(all(launches[k] > 0 for k in ("partition", "sort", "fill")),
                f"join SF={SF8} timers: launches {launches}")
        for k, v in launches.items():
            total[k] += v
        print(f"[suite] join SF={SF8} _run_ici(rounds=2) phase_ms {op.phase_ms}; join-total"
              f" {op.Timers().sum_ms('join-total')} ms; launches {launches} [{card}]", flush=True)
    finally:
        FLAGS.join_timers = False

    with mock.patch.dict(os.environ, SF="1", REFERENCE_SHAPES="1"):
        rc, lines = _quiet(verify_parity.main, [])
    for ln in lines:
        print(f"[suite] verify_parity: {ln}", flush=True)
    require(rc == 0 and "ALL PARITY CHECKS PASS" in lines,
            f"verify_parity REFERENCE_SHAPES=1 SF=1: rc {rc}")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "streaming.json")
        rc, lines = _quiet(bench_streaming.main, ["--op", "filter", "--sf", "1", "2", "--out", out])
        require(rc == 0, f"bench_streaming: rc {rc}")
        with open(out) as f:
            recs = json.load(f)
    require([r["sf"] for r in recs] == [1, 2] and all(r["backend"] == "cuda" for r in recs),
            f"bench_streaming: records {recs}")
    for ln in lines:
        print(f"[suite] bench_streaming: {ln} [{card}]", flush=True)

    rc, lines = _quiet(devicecount.main, [])
    require(rc == 0 and lines and lines[0].endswith("devices allocated (cuda)"),
            f"devicecount: rc {rc}, {lines}")
    for ln in lines:
        print(f"[suite] devicecount: {ln}", flush=True)
    return {k: v for k, v in total.items() if v}


# ---- several devices: one controller over shards --------------------------

MD_KERNELS = ("partition", "sort", "fill", "filter", "sum", "gather")
MD_ROWS_PER_DEV = 1 << 20  # the weak-scaling curve's rows a shard (bench_multichip.py's)


def sync_cards() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _packed_on_card(fk, y):
    """The (fk, y) rows as sorted int64 on the card: a row multiset that two
    results compare by torch.equal."""
    import torch

    return torch.sort(on_card(packed_rows(fk, y).view(np.int64))).values


def phase_multidevice(card: str) -> dict:
    """The port over several devices (parallel/mesh, shuffle, dist_join,
    multihost, partitioner and the operators on a DeviceSet of shards, one
    controller), each path driven once with its launches and the exchange's
    copies and bytes read around it: JoinGpu on BM_JoinDpu SF=8 (16Mi rows
    a side) over 4 shards of the card (_run_ici, with the phase timers),
    beside the same tables' one-device _run_ici in turns; over 2 shards with
    rounds=2 and with impl="sort"; _run_partitioned forced over 4; each
    against the dense truth; dist_join_2d on a 2 x 2 mesh in 1 and 2 rounds
    against the flat join's shards; the exchange with the counts in the
    cells and apart; PartitionGpu's two engines at SF=8, P = 16 over 4
    shards against numpy; FilterGpu, SumGpu and TakeGpu at SF=8 over 4
    shards against pyarrow; HashJoin over 4 shards at SF=1 against pyarrow;
    dryrun_multichip(4); the weak-scaling curve at d = 1, 2, 4. The
    partition, sort, fill, filter, sum and gather kernels' launch counts are
    set to 0 before the phase and must all be above 0 after it. Where the
    machine has 2 or more cards the join and the dry run also run over
    them. DeviceSet.allocate(4) must raise on a machine of fewer cards:
    the phase builds its sets of one card's shards by constructing them."""
    import torch

    from dpu_olap_tpu_torch import plan as P
    from dpu_olap_tpu_torch.bench import multichip
    from dpu_olap_tpu_torch.config import FLAGS
    from dpu_olap_tpu_torch.generator import (
        make_filter_batches, make_join_tables, make_take_batches,
    )
    from dpu_olap_tpu_torch.operators import PartitionGpu
    from dpu_olap_tpu_torch.operators.aggr_op import SumGpu, SumNative
    from dpu_olap_tpu_torch.operators.filter_op import FilterGpu, FilterNative
    from dpu_olap_tpu_torch.operators.join_op import JoinGpu, JoinNative
    from dpu_olap_tpu_torch.operators.take_op import TakeGpu, TakeNative
    from dpu_olap_tpu_torch.metrics import counts
    from dpu_olap_tpu_torch.ops.hashing import bucket_shift, wang_hash_np
    from dpu_olap_tpu_torch.parallel import shuffle
    from dpu_olap_tpu_torch.parallel.dist_join import dist_join
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet
    from dpu_olap_tpu_torch.parallel.multihost import dist_join_2d, make_mesh_2d

    def exchanged(since=(0, 0)):
        """The exchange's copies and bytes counted since the reading ``since``."""
        c = counts()
        return (c.get("exchange.copies", 0) - since[0], c.get("exchange.bytes", 0) - since[1])

    kernels = {k: m for k, m in _plan_kernels().items() if k in MD_KERNELS}
    cards = torch.cuda.device_count()
    if cards < 4:
        try:
            DeviceSet.allocate(4)
        except ValueError as e:
            print(f"[multidevice] DeviceSet.allocate(4) on {cards} card(s) raises: {e}",
                  flush=True)
        else:
            raise SmokeFailure(f"DeviceSet.allocate(4) did not raise on {cards} card(s)")
    cuda0 = torch.device("cuda", 0)
    ds1, ds2, ds4 = (DeviceSet([cuda0] * d) for d in (1, 2, 4))
    t_phase = time.perf_counter()
    sync_cards()
    for mod in kernels.values():
        mod.LAUNCHES = 0

    def drive(label, make_op, run=lambda o: o.Run(), phases=JOIN_PHASES, check=None):
        """One run of a prepared operator: its kernels' launches, the
        exchange's copies and bytes, its Run() and phase times; check(out)
        names the truth it held."""
        op = make_op().Prepare()
        before = {k: m.LAUNCHES for k, m in kernels.items()}
        counted = exchanged()
        sync_cards()
        t = time.perf_counter()
        out = run(op)
        sync_cards()
        ms = (time.perf_counter() - t) * 1e3
        launches = {k: m.LAUNCHES - before[k] for k, m in kernels.items() if m.LAUNCHES > before[k]}
        ph = {name: round(op.Timers().sum_ms(name), 3) for name in phases}
        extra = f"; phase_ms {op.phase_ms}" if getattr(op, "phase_ms", None) else ""
        truth = check(out) if check else "-"
        copies, nbytes = exchanged(counted)
        print(f"[multidevice {label}] == {truth}; Run() {ms:.3f} ms; phases ms {ph}{extra};"
              f" exchange {copies} copies, {nbytes} B;"
              f" launches {launches} [{card}]", flush=True)
        return out, op, copies

    # ---- JoinGpu at SF=8 over shards of the card -------------------------
    left, right = make_join_tables(SF8, SF1_ROWS, SF1_ROWS, seed=SEED)
    lc, rc = left.concat(), right.concat()
    truth_rows = _packed_on_card(lc["fk"], lc["y"])
    pk0 = int(rc["pk"][0])

    def dense(label):
        def check(out):
            require(len(out["fk"]) == lc.num_rows, f"{label}: {len(out['fk'])} rows")
            require(np.array_equal(out["x"], rc["x"][out["fk"].astype(np.int64) - pk0]),
                    f"{label}: x != right_x[fk - pk0]")
            require(torch.equal(_packed_on_card(out["fk"], out["y"]), truth_rows),
                    f"{label}: (fk, y) rows differ from the input")
            return "the dense truth"
        return check

    # one device (_run_ici) and 4 shards (Run(), which routes there) in turns
    # (d1, d4, d4, d1); the first 4-shard run also takes the phase timers
    totals = {1: [], 4: []}
    for i, d in enumerate((1, 4, 4, 1)):
        label = f"join SF={SF8} d={d} {'_run_ici' if d == 1 else 'Run()'}"
        FLAGS.join_timers = i == 1
        try:
            _, op, copies = drive(label, lambda d=d: JoinGpu(ds1 if d == 1 else ds4, left, right),
                                  run=(lambda o: o._run_ici()) if d == 1 else (lambda o: o.Run()),
                                  check=dense(label))
        finally:
            FLAGS.join_timers = False
        require(op._ici_rounds() == 1 and (d == 1 or copies > 0),
                f"{label}: not the shuffle join in one round")
        totals[d].append(op.Timers().sum_ms("join-total"))
    print(f"[multidevice join SF={SF8}] join-total ms, one device {totals[1]} against 4 shards"
          f" of one card {totals[4]} (in turns d1 d4 d4 d1) [{card}]", flush=True)
    drive(f"join SF={SF8} d=2 _run_ici(rounds=2)", lambda: JoinGpu(ds2, left, right),
          run=lambda o: o._run_ici(rounds=2), check=dense("d=2 rounds=2"))
    drive(f"join SF={SF8} d=2 impl=sort", lambda: JoinGpu(ds2, left, right, impl="sort"),
          check=dense("d=2 impl=sort"))

    def partitioned():
        op = JoinGpu(ds4, left, right)
        op.MAX_RESIDENT_ROWS = 1 << 10  # everything "too big"
        return op

    drive(f"join SF={SF8} d=4 partitioned", partitioned, phases=PART_PHASES,
          check=dense("d=4 partitioned"))

    # ---- the 2-D mesh against the flat join, and the in-band counts --------
    cols = [lc["fk"], lc["y"], rc["pk"], rc["x"]]
    mesh = make_mesh_2d(2, 2, ds=ds4)
    for rounds in (1, 2):
        counted = exchanged()
        sync_cards()
        t = time.perf_counter()
        two = dist_join_2d(mesh, cols[0], (cols[1],), cols[2], (cols[3],), rounds=rounds)
        sync_cards()
        ms = (time.perf_counter() - t) * 1e3
        c2, b2 = exchanged(counted)
        flat = dist_join(ds4, cols[0], (cols[1],), cols[2], (cols[3],), rounds=rounds)
        require(not DeviceSet.gather(two[4]).any(), f"2-D rounds={rounds}: overflow")
        for name, a, b in (("fk", two[0], flat[0]), ("y", two[1][0], flat[1][0]),
                           ("x", two[2][0], flat[2][0]), ("matched", two[3], flat[3])):
            require(card_equal(a, b), f"2-D rounds={rounds}: {name} != the flat join's")
        m = DeviceSet.gather(two[3])
        require(int(m.sum()) == lc.num_rows, f"2-D rounds={rounds}: {int(m.sum())} rows")
        print(f"[multidevice dist_join_2d 2x2 rounds={rounds}] == the flat join's shards, bit for"
              f" bit; {ms:.3f} ms with the split; exchange {c2} copies, {b2} B [{card}]",
              flush=True)
    cell = shuffle.default_cell_size(lc.num_rows // 4, 4, FLAGS.shuffle_slack)
    res = {}
    for inband in (False, True):
        keys, pay = ds4.split(cols[0]), (ds4.split(cols[1]),)
        sync_cards()
        ms = cuda_ms(lambda: shuffle.shuffle_partitions(keys, pay, 4, cell, counts_inband=inband))
        counted = exchanged()
        res[inband] = shuffle.shuffle_partitions(keys, pay, 4, cell, counts_inband=inband)
        c2, b2 = exchanged(counted)
        print(f"[multidevice shuffle counts_inband={inband}] 4 shards of {lc.num_rows // 4} rows,"
              f" cell {cell}: {ms:.4f} ms a shuffle (device, median of {REPS}); exchange"
              f" {c2} copies, {b2} B [{card}]", flush=True)
    for a, b in zip(res[False], res[True]):
        require(card_equal([a.keys, a.payloads[0], a.counts], [b.keys, b.payloads[0], b.counts])
                and bool(a.overflow) == bool(b.overflow),
                "the in-band counts' ShuffleResult differs")

    # ---- PartitionGpu, FilterGpu, SumGpu, TakeGpu over 4 shards ------------
    p = 16
    b = wang_hash_np(lc["fk"]) >> np.uint32(bucket_shift(p))
    order = np.argsort(b, kind="stable")
    ends = np.cumsum(np.bincount(b, minlength=p))
    oracle = [{c: lc[c][order[e - n:e]] for c in ("fk", "y")}
              for n, e in zip(np.bincount(b, minlength=p), ends)]

    def parts_check(parts):
        parts = parts.to_host() if hasattr(parts, "to_host") else parts
        require(len(parts) == p and all(
            np.array_equal(g[c], w[c]) for g, w in zip(parts, oracle) for c in ("fk", "y")),
            "partitions != the numpy oracle")
        return "the numpy oracle"

    for resident in (True, False):
        drive(f"partition SF={SF8} P={p} d=4 {'resident' if resident else 'host-staged'}",
              lambda r=resident: PartitionGpu(ds4, left, "fk", p, resident=r),
              phases=("partition-resident",) if resident else ("stage", "dispatch", "collect"),
              check=parts_check)

    table = make_filter_batches(SF8 * 128, 1 << 16, seed=SEED)

    def chunks_equal(nat):
        def check(out):
            require(len(out) == len(nat) and all(np.array_equal(g, e) for g, e in zip(out, nat)),
                    "chunks != pyarrow")
            return "pyarrow"
        return check

    stream = ("stage", "dispatch", "collect")
    drive(f"filter SF={SF8} d=4", lambda: FilterGpu(ds4, table), phases=stream,
          check=chunks_equal(FilterNative(table).Prepare().Run()))
    sums = make_filter_batches(SF8, 1 << 21, seed=SEED)
    want = SumNative(sums).Prepare().Run()
    drive(f"sum SF={SF8} d=4", lambda: SumGpu(ds4, sums), phases=stream,
          check=lambda got: require(got == want, f"sum {got} != {want}") or "pyarrow")
    data, idx = make_take_batches(SF8, 1 << 22, 1 << 19, seed=SEED)
    drive(f"take SF={SF8} d=4", lambda: TakeGpu(ds4, data, idx), phases=stream,
          check=chunks_equal(TakeNative(data, idx).Prepare().Run()))

    # ---- a plan, the dry run, the weak-scaling curve -----------------------
    l1, r1 = make_join_tables(1, SF1_ROWS, SF1_ROWS, seed=SEED)
    nat = JoinNative(l1, r1).Prepare().Run()

    class PlanOp:  # a plan execution as drive() takes it
        def __init__(self):
            from dpu_olap_tpu_torch.timer import Timers

            self.timers = Timers()

        def Prepare(self):
            return self

        def Run(self):
            return P.HashJoin(P.Source(l1), P.Source(r1)).execute(ds4)[0].to_numpy()

        def Timers(self):
            return self.timers

    def plan_check(out):
        check_rows("plan HashJoin d=4", out, *(nat[c].to_numpy() for c in ("fk", "y", "x")))
        return "pyarrow"

    drive("plan HashJoin SF=1 d=4", PlanOp, phases=(), check=plan_check)

    sync_cards()
    t = time.perf_counter()
    _, lines = _quiet(multichip.dryrun_multichip, 4)
    for ln in lines:
        print(f"[multidevice dryrun] {ln}", flush=True)
    require(sum(" ok" in ln for ln in lines) == 7, f"dryrun_multichip(4): {lines}")
    print(f"[multidevice dryrun] dryrun_multichip(4) on {cards} card(s):"
          f" {time.perf_counter() - t:.1f} s [{card}]", flush=True)

    curve, _ = _quiet(multichip.bench, 4, MD_ROWS_PER_DEV, True)
    print(f"[multidevice weak scaling] {json.dumps(curve)} [{card}]", flush=True)
    print(f"[multidevice weak scaling] the {curve['devices']} shards share"
          f" {curve['physical_devices']} card(s): the curve measures the overhead of the split"
          f" and the exchange, not a speed-up [{card}]", flush=True)

    if cards >= 2:  # real devices: 2 or 4, which divide the tables' rows and batches
        dsr = DeviceSet.allocate(4 if cards >= 4 else 2)
        drive(f"join SF={SF8} over {dsr.nr_devices} cards", lambda: JoinGpu(dsr, left, right),
              check=dense(f"{dsr.nr_devices} cards"))
        _, lines = _quiet(multichip.dryrun_multichip, 4)
        for ln in lines:
            print(f"[multidevice dryrun cards] {ln}", flush=True)
    else:
        print("[multidevice] one card: no run over several physical devices", flush=True)

    sync_cards()
    launches = {k: m.LAUNCHES for k, m in kernels.items()}
    require(all(launches[k] > 0 for k in MD_KERNELS),
            f"[multidevice]: a kernel did not launch: {launches}")
    print(f"[multidevice] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s"
          f" [{card}]", flush=True)
    return launches


# ---- one process a device: the process-group form --------------------------

PG_KERNELS = ("partition", "sort", "fill", "gather")


def _pg_gloo_ranks(gs, sf: int) -> dict:
    """One rank of the 4-rank gloo spawn: BM_JoinDpu's join at world 4, at
    world 2 (ranks 0 and 1, a subgroup) and on the 2 x 2 mesh; every rank
    creates the same subgroups in the same order."""
    from dpu_olap_tpu_torch.bench import multiproc

    pair = gs.subgroups([[0, 1]])
    return {"4": multiproc.rank_join(gs, sf),
            "2": multiproc.rank_join(pair, sf) if pair is not None else None,
            "2x2": multiproc.rank_join(gs, sf, mesh=(2, 2))}


def _pg_line(label: str, ranks: list, want: list, card: str) -> dict:
    """Hold the ranks' readings to the one-controller shards' digests and
    print them; returns the ranks' kernel launches summed."""
    for r, w in zip(ranks, want):
        require(r["ok"], f"{label} rank {r['rank']}: not the dense truth")
        require(r["digest"] == w, f"{label} rank {r['rank']}: outputs != the one-controller"
                f" join's shard {r['rank']}")
        require(r["collectives"] > 0, f"{label} rank {r['rank']}: no collective ran")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in PG_KERNELS}
    per = "; ".join(f"rank {r['rank']} join-total {r['join_total_ms']:.3f} ms, exchange"
                    f" {r['exchange_ms']:.3f} ms, {r['exchange_bytes']} B in"
                    f" {r['collectives']} collectives" for r in ranks)
    print(f"[process_group {label}] == the one-controller join's shards (SHA-256 of fk, y, x,"
          f" matched), the dense truth; {per}; launches {launches} [{card}]", flush=True)
    return launches


def phase_process_group(card: str) -> dict:
    """The process-group form (parallel/process_group.py, one process a
    device) on BM_JoinDpu SF=8 (16Mi rows a side), each rank's join through
    bench/multiproc.rank_join (its launches, exchange bytes and collectives
    counted around its timed join, its matched rows gathered to rank 0 and
    held to the dense truth): NCCL at world = the visible cards (in this
    process on one card), in 1 and 2 rounds, each rank's outputs equal bit
    for bit (SHA-256) to its shard of the one-controller dist_join on the
    same tables; then one spawn of 4 gloo ranks, every rank on cuda:0, at
    world 4, at world 2 (a subgroup) and on the 2 x 2 mesh, each against
    the one-controller dist_join over DeviceSet([cuda:0] * d) or
    dist_join_2d over its 4 shards. The libraries are built before any rank
    starts (phase_build); the ranks load them. The partition, sort and
    fill kernels must launch in the ranks' joins."""
    import torch

    from dpu_olap_tpu_torch.bench import multiproc
    from dpu_olap_tpu_torch.generator import make_join_tables
    from dpu_olap_tpu_torch.parallel import process_group as pg
    from dpu_olap_tpu_torch.parallel.dist_join import dist_join
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet
    from dpu_olap_tpu_torch.parallel.multihost import dist_join_2d, make_mesh_2d

    t_phase = time.perf_counter()
    left, right = make_join_tables(SF8, SF1_ROWS, SF1_ROWS, seed=multiproc.SEED)
    lc, rc = left.concat(), right.concat()
    cols = (lc["fk"], (lc["y"],), rc["pk"], (rc["x"],))
    cuda0 = torch.device("cuda", 0)

    def shard_digests(out):
        fk, lcols, rcols, matched, _ = out
        if isinstance(fk, torch.Tensor):
            return [multiproc.digest(fk, lcols, rcols, matched)]
        return [multiproc.digest(fk[t], tuple(c[t] for c in lcols), tuple(c[t] for c in rcols),
                                 matched[t]) for t in range(len(fk))]

    total = {k: 0 for k in PG_KERNELS}
    cards = torch.cuda.device_count()
    for rounds in (1, 2):
        want = shard_digests(dist_join(DeviceSet([cuda0] * cards), *cols, keys31=True,
                                       rounds=rounds))
        torch.cuda.empty_cache()
        if cards == 1:
            with pg.init_group("nccl", 0, 1, f"tcp://127.0.0.1:{pg.free_port()}") as gs:
                ranks = [multiproc.rank_join(gs, SF8, rounds=rounds)]
        else:
            ranks = pg.spawn(multiproc.rank_join, cards, args=(SF8, None, rounds),
                             backend="nccl")
        torch.cuda.empty_cache()
        for k, n in _pg_line(f"nccl world {cards} rounds={rounds}", ranks, want, card).items():
            total[k] += n
    want = {d: shard_digests(dist_join(DeviceSet([cuda0] * d), *cols, keys31=True))
            for d in (4, 2)}
    want["2x2"] = shard_digests(dist_join_2d(make_mesh_2d(2, 2, ds=DeviceSet([cuda0] * 4)),
                                             *cols))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = pg.spawn(_pg_gloo_ranks, 4, args=(SF8,), backend="gloo", device="cuda:0",
                     timeout_s=240)
    spawn_s = time.perf_counter() - t
    for label, key in (("gloo world 4", "4"), ("gloo world 2", "2"), ("gloo mesh 2x2", "2x2")):
        got = [r[key] for r in ranks if r[key] is not None]
        for k, n in _pg_line(label, got, want[key if key == "2x2" else int(key)], card).items():
            total[k] += n
    print(f"[process_group gloo] 4 ranks on cuda:0 (one spawn, {spawn_s:.1f} s): the ranks"
          f" hand gloo's all_to_all_single their CUDA tensors, and gloo stages them through"
          f" host memory inside itself [{card}]", flush=True)
    require(all(total[k] > 0 for k in ("partition", "sort", "fill")),
            f"[process_group]: a kernel did not launch in the ranks: {total}")
    print(f"[process_group] launches {total} (the shuffle join launches no gather); phase"
          f" {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return total


def phase_trace_hook(card: str) -> None:
    """ENABLE_TRACE=1 in a subprocess: filter v1 on 1Mi values prints one
    line a tile; the tiles are numbered 0..255 once each, their offsets are
    the running sums of their counts, their counts add up to the filter's,
    and the lines equal the plain version's."""
    import os

    code = (
        "import ctypes, json, torch\n"
        "from dpu_olap_tpu_torch.ops import filter as f, filter_cuda\n"
        "g = torch.Generator(device='cuda').manual_seed(%d)\n"
        "x = torch.randint(-2**31, 2**31, (%d,), dtype=torch.int32, device='cuda',"
        " generator=g).view(torch.uint32)\n"
        "_, c = f.filter_compact(x)\n"
        "torch.cuda.synchronize()\n"
        "ctypes.CDLL(None).fflush(None)\n"
        "print('count', int(c))\n"
        "print('expect', json.dumps(filter_cuda.trace_lines(x.cpu())))\n"
    ) % (SEED, TRACE_N)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "ENABLE_TRACE": "1"})
    require(res.returncode == 0, f"ENABLE_TRACE subprocess failed: {res.stderr[-2000:]}")
    lines = [x for x in res.stdout.splitlines() if x.startswith("filter block")]
    count = int(next(x for x in res.stdout.splitlines() if x.startswith("count ")).split()[1])
    expect = json.loads(next(x for x in res.stdout.splitlines() if x.startswith("expect "))[7:])
    rows = sorted((int(w[2]), int(w[4]), int(w[6])) for w in (x.split() for x in lines))
    tiles = -(-TRACE_N // 4096)
    require([t for t, _, _ in rows] == list(range(tiles)),
            f"ENABLE_TRACE: {len(lines)} lines do not number the {tiles} tiles once each")
    require(sum(k for _, _, k in rows) == count, "ENABLE_TRACE: the kept counts do not add up")
    require([o for _, o, _ in rows] == [sum(k for _, _, k in rows[:t]) for t in range(tiles)],
            "ENABLE_TRACE: an offset is not the count of the tiles before it")
    require(sorted(lines) == sorted(expect), "ENABLE_TRACE: lines != the plain version's")
    print(f"[trace hook] ENABLE_TRACE=1: {len(lines)} 'filter block' lines for {tiles} tiles,"
          f" kept summing to the count {count}, == the plain version's [{card}]", flush=True)


def main() -> dict:
    import torch

    print(f"[env] torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    card = card_line()
    print(f"[env] card: {card}", flush=True)
    torch.cuda.set_device(0)

    # the package is imported only inside the phases: a copy of this script
    # outside the repo fails at the build
    phase_build()
    rng = np.random.default_rng(SEED)
    phase_glue(rng)
    phase_native(card)
    phase_trace_hook(card)
    phase_join_entry_points(rng)
    measured = phase_sort_gather(rng, card)
    measured["filter_compact"] = phase_filter_kernel(rng, card)
    measured["sum_u64_pair"] = phase_sum_kernel(rng, card)
    fills = phase_fill_kernels(rng, card)
    measured["propagate_fill"] = fills["propagate_fill"]
    measured["propagate_last"] = fills["propagate_last"]
    measured["bitonic_merge_blocks"] = phase_merge_kernels(rng, card)
    measured["partition_cells"] = phase_partition_kernel(rng, card)
    phase_round_kernels(card)
    measured["merge_probe"] = phase_merge_probe_kernel(rng, card)
    # the filter alternates and the stage ablation lie on no operator path:
    # their launches are counted around the measurement entry point's run
    rng_alt = np.random.default_rng(SEED + 5)
    for ver, row in phase_filter_alternates(rng_alt, card).items():
        measured[f"filter_compact_{ver}"] = row
    measured["filter_stages"] = phase_filter_stages(rng_alt, card)
    # the probe kernels and the sort's tile stage lie on no operator path
    # either: their launches are counted around the entry points that run them
    rng_probe = np.random.default_rng(SEED + 6)
    measured.update(phase_block_ops(rng_probe, card))
    measured.update(phase_probes(rng_probe, card))
    measured["sort_tiles"] = phase_sort_tiles(rng_probe, card)
    filter_launches = phase_measure_filter(card)
    filter_launches.update(phase_measure_r3(card))
    filter_launches.update(phase_probe_lowering(card))

    launches = {"sort": 0, "gather": 0, "filter": 0, "sum": 0, "merge": 0, "fill": 0,
                "partition": 0, "merge_probe": 0}
    paths = [lambda sf=sf, ph=ph: ph(sf, card)
             for sf in (1, SF8) for ph in (phase_join, phase_filter, phase_sum, phase_take)]
    paths.append(lambda: phase_join_fallbacks(card))
    # this slice's paths, the SF=64 shuffle join (its main path) first
    paths += [lambda ph=ph: ph(card) for ph in (
        phase_join_shuffle_sf64, phase_join_shuffle_sf8, phase_join_partitioned_sf8,
        phase_partition_sf8, phase_hashtable,
    )]
    paths.append(lambda: phase_plan(card))  # the query plan's chains
    paths.append(lambda: phase_suite(card))  # the operator suite and its entry points
    paths.append(lambda: phase_multidevice(card))  # several devices, one controller
    paths.append(lambda: phase_process_group(card))  # one process a device
    for path in paths:
        for name, n in path().items():
            launches[name] += n
    launches["last"] = fills["last_launches"]  # propagate_last is on no operator path
    launches.update(filter_launches)

    sources = {
        "sort_bitonic": ("sort", "radix_sort.cu", "dpu_olap_tpu/ops/sort_pallas.py:385", [
            "dpu_olap_tpu/ops/sort_pallas.py:286",
            "dpu_olap_tpu/ops/sort_pallas.py:103",
            "dpu_olap_tpu/ops/sort_pallas.py:327",
        ]),
        "gather_sorted": ("gather", "gather.cu", "dpu_olap_tpu/ops/take_pallas.py:219", None),
        "filter_compact": ("filter", "filter.cu", "dpu_olap_tpu/ops/filter_pallas.py:314", [
            "dpu_olap_tpu/ops/filter_pallas.py:314",
            "dpu_olap_tpu/ops/filter_pallas.py:375",
            "dpu_olap_tpu/ops/filter_pallas.py:448",
        ]),
        "sum_u64_pair": ("sum", "sum.cu", "dpu_olap_tpu/ops/aggregate.py:113", None),
        "propagate_fill": ("fill", "scan.cu", "dpu_olap_tpu/ops/scan_pallas.py:178", None),
        "propagate_last": ("last", "scan.cu", "dpu_olap_tpu/ops/scan_pallas.py:222", None),
        "bitonic_merge_blocks": ("merge", "sort.cu", "dpu_olap_tpu/ops/bitonic_pallas.py:91",
                                 ["dpu_olap_tpu/ops/sort_pallas.py:327"]),
        "partition_cells": ("partition", "partition.cu",
                            "dpu_olap_tpu/ops/partition_pallas.py:161", None),
        "merge_probe": ("merge_probe", "merge_probe.cu", "dpu_olap_tpu/ops/merge_pallas.py:250",
                        None),
        **{f"filter_compact_{ver}": (f"filter{ver[1]}", src, replaces, None)
           for ver, src, replaces in ALTERNATES},
        "filter_stages": ("stages", "filter.cu", "scripts/measure_filter.py:387",
                          ["scripts/measure_filter.py:304"]),
        "block_ops": ("block_ops", "block_ops.cu", "scripts/measure_filter.py:459", [
            "scripts/measure_filter.py:439", "scripts/measure_filter.py:469",
            "scripts/measure_filter.py:474", "scripts/measure_filter.py:492",
        ]),
        "block_cops": ("block_cops", "block_ops.cu", "scripts/measure_filter.py:264", [
            "scripts/measure_filter.py:237", "scripts/measure_filter.py:274",
        ]),
        "lane_gather": ("lane_gather", "probes.cu", "scripts/measure_r3.py:219",
                        ["scripts/measure_r3.py:226"]),
        "lowering_probes": ("lowering", "probes.cu", "measurements/_probe_v4_lowering.py:50", [
            "measurements/_probe_v4_lowering.py:33", "measurements/_probe_v4_lowering.py:37",
            "measurements/_probe_v4_lowering.py:41", "measurements/_proto_lower.py:27",
            "measurements/_proto_lower.py:15", "measurements/_proto_lower2.py:10",
        ]),
        "sort_tiles": ("tiles", "sort.cu", "dpu_olap_tpu/ops/sort_pallas.py:286",
                       ["scripts/measure_filter.py:562"]),
    }
    kernels = []
    for name, (counter, src, replaces, also) in sources.items():
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"dpu_olap_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[counter],
            **measured[name],
        }
        if also:
            entry["replaces_kernels"] = also
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[card] {card}", flush=True)
    return {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }


if __name__ == "__main__":
    try:
        result = main()
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
    except Exception:
        traceback.print_exc()
        print("FAIL: chip_smoke raised", flush=True)
        sys.exit(1)
    print(json.dumps(result), flush=True)
