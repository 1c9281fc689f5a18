"""Partitioned hash join over the shuffle (counterpart of
``dpu_olap_tpu/parallel/dist_join.py``).

Reference: host/join/join_dpu.cc — Phase A partitions both tables with the
shared Partitioner (:82-142, 200-233); Phase B runs HashBuild, HashProbe and
a Take per value column on each partition pair (:254-369).

As in the JAX package, both sides are co-shuffled by the Wang-hash radix
bucket of the key (parallel/shuffle.py), so equal keys land in the same
partition, and each partition pair is joined locally (ops/join.py). With
``rounds`` > 1 each device holds that many resident partition pairs and joins
them one after another — the JAX package's ``lax.scan`` is a Python loop
here — which bounds the join's working set to 1/rounds of the data; this is
how one device joins tables above ``JoinGpu.SINGLE_ROUND_ROWS``. Over a
DeviceSet of several devices (``dist_join_spmd``, one controller) each
shard's rows are co-shuffled through the exchange and each device joins its
partitions; the launches are asynchronous, so devices work side by side.

Output: padded rows (the local join's layout, round after round) + a
matched mask; over several devices a tuple of shards each, shard t on device
t, and one overflow flag a device. The host compacts them
(operators/join_op.py), as the reference reassembles batches on the host
(join_dpu.cc:371-399).

``dist_join_phase_ms`` attributes the join's device time to its phases
(fragments, exchange, local join) for FLAGS.join_timers.

Over a process group (one process a device, ``parallel/process_group.py``)
``dist_join`` takes a GroupSet in place of the DeviceSet: the same code,
each rank holding one shard, moving it by the group's exchange and joining
its own partitions. ``dist_join_retry`` is JoinGpu's cell-doubling retry
over either set, decided from every device's or rank's flag, and
``dist_join_phase_ms_group`` times the phases on each rank.
"""

from __future__ import annotations

import functools
import operator
import time
from typing import Tuple

import numpy as np
import torch

from ..config import FLAGS
from ..metrics import log, trace
from .mesh import DeviceSet
from .shuffle import ShuffleResult, default_cell_size, shuffle_partitions


def join_shuffled(left: ShuffleResult, right: ShuffleResult, impl: str = "cosort",
                  keys31: bool = False):
    """Join two ShuffleResults on the device. rounds > 1 joins the resident
    per-round partition planes in order; nothing leaves the device between
    rounds (the reference bounces every fragment through host slabs,
    join_dpu.cc:254-369).

    Returns (fk, left_cols, right_cols, matched, overflow). Runs in the span
    dpu_olap.dist.join."""
    from ..ops.join import join_shard, join_shard_fused  # avoid cycles

    def local_join(lk, lp, l_valid, rk, rp, r_valid):
        if impl == "cosort":
            # fused path: payloads ride the sort, no gathers (rows come back
            # key-sorted; consumers compact by the matched mask anyway)
            return join_shard_fused(
                lk, lp, rk, rp, left_valid=l_valid, right_valid=r_valid, keys31=keys31,
            )
        return join_shard(lk, lp, rk, rp, left_valid=l_valid, right_valid=r_valid, impl=impl)

    with trace("dpu_olap.dist.join"):
        overflow = (left.overflow | right.overflow).reshape(1)
        assert left.rounds == right.rounds
        if left.rounds == 1:
            rk, rp, r_valid = right.flat()
            lk, lp, l_valid = left.flat()
            fk, lcols, rcols, matched = local_join(lk, lp, l_valid, rk, rp, r_valid)
            return fk, lcols, rcols, matched, overflow

        lkp, lpp, lvp = left.round_planes()  # (R, d*cell_l) each
        rkp, rpp, rvp = right.round_planes()
        outs = [
            local_join(lkp[r], tuple(p[r] for p in lpp), lvp[r],
                       rkp[r], tuple(p[r] for p in rpp), rvp[r])
            for r in range(left.rounds)
        ]

        n_l, n_r = len(outs[0][1]), len(outs[0][2])
        return (
            torch.cat([o[0] for o in outs]),
            tuple(torch.cat([o[1][k] for o in outs]) for k in range(n_l)),
            tuple(torch.cat([o[2][k] for o in outs]) for k in range(n_r)),
            torch.cat([o[3] for o in outs]),
            overflow,
        )


RETRIES = 4  # joins, the cells doubled after each overflow, before a skewed input raises
PHASE_REPS = 3  # timed runs of each phase, after a warm-up one


def _on_device(ds, a):
    """A host numpy array or a tensor (the whole column) on ds: on one
    device under one controller the tensor there; otherwise split into the
    tuple of shards this process holds (a GroupSet's: its rank's one). A
    tuple of shards is taken as it is."""
    if isinstance(a, (tuple, list)):
        return tuple(a)
    if ds.nr_devices > 1 or not isinstance(ds, DeviceSet):
        return ds.split(a)
    if isinstance(a, np.ndarray):
        return ds.scatter(a)
    return a.to(ds.device)


def _whole(ds: DeviceSet, a) -> torch.Tensor:
    """A host array, a tensor or a tuple of shards as one tensor on ds's
    first device."""
    if isinstance(a, (tuple, list)):
        return torch.cat([s.to(ds.device) for s in a])
    return ds.scatter(a) if isinstance(a, np.ndarray) else a.to(ds.device)


def _columns(per_device) -> tuple:
    """Per-device (fk, left_cols, right_cols, matched, overflow) as the
    same five outputs, each a tuple of shards (a column of shards for each
    left and right column)."""
    fk, lcols, rcols, matched, overflow = zip(*per_device)
    return (fk, tuple(zip(*lcols)), tuple(zip(*rcols)), matched, overflow)


def dist_join_spmd(
    left_fk: tuple,
    left_payloads: tuple,
    right_pk: tuple,
    right_payloads: tuple,
    nr_partitions: int,
    cell_left: int,
    cell_right: int,
    impl: str = "cosort",
    keys31: bool = False,
    rounds: int = 1,
    ds=None,
):
    """The per-device program over every shard this process holds (JAX
    dist_join.py:84): the co-shuffle of both sides (one exchange each, by
    ds's exchange, as shuffle_partitions), then join_shuffled on each
    device. Inputs are tuples of shards (each payload a column of shards);
    returns (fk, left_cols, right_cols, matched, overflow), each a tuple of
    shards, overflow (1,) a device. Over a process group (ds a GroupSet)
    the tuples hold this rank's one shard, and its outputs are shard t of
    the one-controller form."""
    right = shuffle_partitions(right_pk, right_payloads, nr_partitions, cell_right, rounds=rounds,
                               ds=ds)
    left = shuffle_partitions(left_fk, left_payloads, nr_partitions, cell_left, rounds=rounds,
                              ds=ds)
    return _columns([join_shuffled(lt, rt, impl=impl, keys31=keys31)
                     for lt, rt in zip(left, right)])


def _shard_rows(x, nr_devices: int) -> int:
    """Rows a shard: of a tuple of shards (this process's), or of a whole
    column split over nr_devices."""
    if isinstance(x, (tuple, list)):
        return sum(s.shape[0] for s in x) // len(x)
    return x.shape[0] // nr_devices


def _cell(ds, x, rounds: int) -> int:
    """The default cell of a column (whole, or this process's shards) over
    ds, from its rows a shard."""
    return default_cell_size(_shard_rows(x, ds.nr_devices), ds.nr_devices * rounds,
                             FLAGS.shuffle_slack)


def dist_join(
    ds,
    left_fk,
    left_payloads: Tuple,
    right_pk,
    right_payloads: Tuple,
    impl: str = "cosort",
    cell_left: int | None = None,
    cell_right: int | None = None,
    keys31: bool = False,
    rounds: int = 1,
):
    """Run the partitioned join of uint32 columns: host numpy arrays or
    tensors, split over ds's devices (a tuple of shards is taken as it is).
    Returns padded outputs (fk, left_cols, right_cols, matched, overflow):
    both sides co-shuffled into nr_devices * rounds partitions, then joined
    (join_shuffled). rounds > 1 joins the data as that many resident
    partition rounds. On one device each output is a tensor; over several,
    a tuple of shards (``dist_join_spmd``).

    ``ds`` may be a GroupSet (one process a device): each rank takes its
    own rows of the whole columns (GroupSet.split) or is given its shard as
    a 1-tuple, and gets back its own partitions' rows, each output a 1-tuple;
    the cells are sized from the rows a shard, as above."""
    cell_left = cell_left or _cell(ds, left_fk, rounds)
    cell_right = cell_right or _cell(ds, right_pk, rounds)
    left_fk, right_pk = _on_device(ds, left_fk), _on_device(ds, right_pk)
    left_payloads = tuple(_on_device(ds, p) for p in left_payloads)
    right_payloads = tuple(_on_device(ds, p) for p in right_payloads)
    if isinstance(left_fk, tuple):
        return dist_join_spmd(left_fk, left_payloads, right_pk, right_payloads, ds.nr_devices,
                              cell_left, cell_right, impl=impl, keys31=keys31, rounds=rounds,
                              ds=ds)
    right = shuffle_partitions(right_pk, right_payloads, 1, cell_right, rounds=rounds)
    left = shuffle_partitions(left_fk, left_payloads, 1, cell_left, rounds=rounds)
    return join_shuffled(left, right, impl=impl, keys31=keys31)


def dist_join_retry(ds, left_fk, left_payloads: Tuple, right_pk, right_payloads: Tuple,
                    impl: str = "cosort", cell_left: int | None = None,
                    cell_right: int | None = None, keys31: bool = False, rounds: int = 1):
    """``dist_join`` with the skew handling of JoinGpu: when a cell
    overflows on any device or rank (``ds.any``: over a process group one
    decision that every rank takes alike), double both cells and join again,
    up to RETRIES joins; then raise OverflowError (the reference throws at
    once, partition.cc:19-26). Returns the outputs and the cells (left,
    right) they were joined with. Columns placed on ds (tensors there, or
    tuples of shards) are not placed again for a retry."""
    cell_left = cell_left or _cell(ds, left_fk, rounds)
    cell_right = cell_right or _cell(ds, right_pk, rounds)
    for attempt in range(RETRIES):
        out = dist_join(ds, left_fk, left_payloads, right_pk, right_payloads, impl=impl,
                        cell_left=cell_left, cell_right=cell_right, keys31=keys31, rounds=rounds)
        with trace("dpu_olap.dist.vote"):
            over = ds.any(out[4])
        if not over:
            return out, (cell_left, cell_right)
        log(f"join shuffle overflow (attempt {attempt}): cells {cell_left} / {cell_right}"
            " doubled")
        cell_left, cell_right = cell_left * 2, cell_right * 2
    raise OverflowError("shuffle cell overflow after retries")


def dist_join_phase_ms(
    ds: DeviceSet,
    left_fk,
    right_pk,
    n_left_payloads: int,
    n_right_payloads: int,
    cell_left: int,
    cell_right: int,
    impl: str = "cosort",
    keys31: bool = False,
    rounds: int = 1,
    k: int = 4,
) -> dict:
    """Per-phase attribution for the shuffle join (JAX dist_join.py:182-292),
    the reference's ACTIVATE_JOIN_TIMERS build (host/join/join_dpu.cc:27-49),
    which splits partition / exchange / build+probe+take. Chained pipeline
    PREFIXES are timed (bench/device_time.time_chained) and the deltas
    attributed:

      fragments  = local radix partition into cells (both sides)
      exchange   = + shuffle_partitions (the identity on one device, timed
                   all the same: its fragments are the exchange's input)
      local-join = + join_shuffled

    Over several devices each step splits the carry (the left keys, on the
    first device) into one shard a device, runs every device's part and
    sums the devices' checksums on the first device. Each prefix is one CUDA
    graph of k and of 2k chained steps where every shard lies on one
    physical device; over several physical devices the chains run eagerly,
    timed by CUDA events on the first device. Payload
    planes are derived on the device from the key (same shapes and traffic
    as the real columns), the right side is tied to the carry, and each
    step's checksum, overflow flags included, folds into bit 0 of the next
    step's keys, so every step depends on the one before and the keys stay
    in their range (keys31 holds). The cuckoo probe reads its build's
    convergence back on the host, so its chains run eagerly (still CUDA
    events). Opt-in, as the reference flag: each prefix runs k + 2k steps
    in each of three reps, after a warm-up. Returns ms per phase."""
    from ..bench.device_time import time_chained
    from .shuffle import local_fragments

    n_dev = ds.nr_devices

    # uint32 columns move through the bitwise glue as int32 bit patterns:
    # torch has no uint32 bitwise kernels on the card
    def i32(x):
        return x.view(torch.int32)

    def planes(key, n):
        return tuple((i32(key) ^ (i + 1)).view(torch.uint32) for i in range(n))

    def s64(*xs):
        return sum(x.to(torch.int64).sum() for x in xs)

    def low(xs, mask):
        return s64(*(i32(x) & mask for x in xs))

    def sides(lf, rk):
        # tie the (otherwise loop-invariant) right side to the carry
        return lf, (i32(rk) ^ (i32(lf[:1]) & 1)).view(torch.uint32)

    def fold(lf, chk):
        return (i32(lf) ^ (chk & 1).to(torch.int32)).view(torch.uint32)

    def shards(x):
        """The carry-side tensor x (on the first device) as one shard a
        device: views on a set of one physical device."""
        return tuple(c.to(dev) for c, dev in zip(x.chunk(n_dev), ds.devices))

    def columns(keys, n):
        """n payload columns derived from sharded keys, each a tuple of
        shards."""
        return tuple(zip(*(planes(key, n) for key in keys)))

    def total(chks):
        """Per-device checksums summed on the first device."""
        return functools.reduce(operator.add, (c.to(ds.device) for c in chks))

    def frag_body(lf, rk):
        lf, rk = sides(lf, rk)
        chks = []
        for ls, rs in zip(shards(lf), shards(rk)):
            ck_l, cp_l, cnt_l, ovf_l = local_fragments(
                ls, planes(ls, n_left_payloads), n_dev * rounds, cell_left)
            ck_r, cp_r, cnt_r, ovf_r = local_fragments(
                rs, planes(rs, n_right_payloads), n_dev * rounds, cell_right)
            chks.append(low([ck_l], 1) + low([ck_r], 3) + s64(cnt_l, cnt_r, ovf_l, ovf_r)
                        + low([*cp_l, *cp_r], 7))
        return fold(lf, total(chks))

    def shuffled(lf, rk):
        lf, rk = sides(lf, rk)
        ls, rs = shards(lf), shards(rk)
        right = shuffle_partitions(rs, columns(rs, n_right_payloads), n_dev, cell_right,
                                   rounds=rounds)
        left = shuffle_partitions(ls, columns(ls, n_left_payloads), n_dev, cell_left,
                                  rounds=rounds)
        return left, right

    def shuf_body(lf, rk):
        chks = [low([lt.keys], 1) + low([rt.keys], 3)
                + s64(lt.counts, rt.counts, lt.overflow, rt.overflow)
                + low([*lt.payloads, *rt.payloads], 7)
                for lt, rt in zip(*shuffled(lf, rk))]
        return fold(lf, total(chks))

    def join_body(lf, rk):
        chks = []
        for lt, rt in zip(*shuffled(lf, rk)):
            fk, lcols, rcols, matched, overflow = join_shuffled(lt, rt, impl=impl, keys31=keys31)
            chks.append(low([fk], 1) + s64(matched, overflow) + low([*lcols, *rcols], 3))
        return fold(lf, total(chks))

    lf, rk = _whole(ds, left_fk), _whole(ds, right_pk)
    # a CUDA graph is captured on one device: a set over several physical
    # devices times its chains eagerly (each step ends in the first device's
    # carry, which waits for every device's work)
    graph = impl != "cuckoo" and len(ds.physical) == 1
    phases = {}
    prev = 0.0
    for name, body in (("fragments", frag_body), ("exchange", shuf_body),
                       ("local-join", join_body)):
        sec = time_chained(body, lf, k=k, consts=(rk,), graph=graph)
        phases[f"{name}-ms"] = sec * 1e3 - prev
        prev = sec * 1e3
    return phases


def dist_join_phase_ms_group(gs, left_fk, right_pk, n_left_payloads: int,
                             n_right_payloads: int, cell_left: int, cell_right: int,
                             impl: str = "cosort", keys31: bool = False, rounds: int = 1,
                             mesh=None) -> dict:
    """This rank's device ms of the shuffle join's phases over a process
    group (gs; left_fk and right_pk this rank's shard, a tensor), the
    counterpart of ``dist_join_phase_ms``: fragments (the local partition
    of both sides), exchange (both sides' collectives and unstacking; over
    a ProcessMesh2D ``mesh``, its two stages) and local-join
    (join_shuffled), each timed alone after a barrier (every rank's device
    work done, then every rank), by CUDA events on a card and the host
    clock on the CPU; payload planes derived from the keys as there.
    Median of PHASE_REPS runs after a warm-up run."""
    from .multihost import move_fragments_2d
    from .shuffle import local_fragments, move_fragments

    left_fk, right_pk = gs.put(left_fk), gs.put(right_pk)
    p = gs.world_size * rounds
    inband = FLAGS.shuffle_counts_inband

    def move(frag, cell):
        if mesh is not None:
            return move_fragments_2d(mesh, [frag], rounds)[0]
        return move_fragments(gs, [frag], cell, rounds, inband)[0]

    def planes(key, n):
        return tuple((key.view(torch.int32) ^ (i + 1)).view(torch.uint32) for i in range(n))

    lp, rp = planes(left_fk, n_left_payloads), planes(right_pk, n_right_payloads)
    on_card = gs.device.type == "cuda"

    def timed(fn):
        gs.barrier()
        if not on_card:
            t = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t) * 1e3
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        return out, start.elapsed_time(stop)

    got = {"fragments-ms": [], "exchange-ms": [], "local-join-ms": []}
    for rep in range(PHASE_REPS + 1):
        frags, f_ms = timed(lambda: (local_fragments(right_pk, rp, p, cell_right),
                                     local_fragments(left_fk, lp, p, cell_left)))
        (right, left), x_ms = timed(lambda: tuple(
            move(f, cell) for f, cell in zip(frags, (cell_right, cell_left))))
        _, j_ms = timed(lambda: join_shuffled(left, right, impl=impl, keys31=keys31))
        if rep:  # the first run warms the allocator and the collectives
            for name, ms in zip(got, (f_ms, x_ms, j_ms)):
                got[name].append(ms)
    return {name: float(np.median(v)) for name, v in got.items()}
