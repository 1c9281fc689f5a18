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
how one device joins tables above ``JoinGpu.SINGLE_ROUND_ROWS``. More than
one device raises in the exchange (shuffle_partitions) until it is ported
(ROADMAP §1, "Multi-device").

Output: padded rows (the local join's layout, round after round) + a
matched mask; the host compacts them (operators/join_op.py), as the
reference reassembles batches on the host (join_dpu.cc:371-399).

``dist_join_phase_ms`` attributes the join's device time to its phases
(fragments, exchange, local join) for FLAGS.join_timers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import FLAGS
from .mesh import DeviceSet
from .shuffle import ShuffleResult, default_cell_size, shuffle_partitions


def join_shuffled(left: ShuffleResult, right: ShuffleResult, impl: str = "cosort",
                  keys31: bool = False):
    """Join two ShuffleResults on the device. rounds > 1 joins the resident
    per-round partition planes in order; nothing leaves the device between
    rounds (the reference bounces every fragment through host slabs,
    join_dpu.cc:254-369).

    Returns (fk, left_cols, right_cols, matched, overflow)."""
    from ..ops.join import join_shard, join_shard_fused  # avoid cycles

    def local_join(lk, lp, l_valid, rk, rp, r_valid):
        if impl == "cosort":
            # fused path: payloads ride the sort, no gathers (rows come back
            # key-sorted; consumers compact by the matched mask anyway)
            return join_shard_fused(
                lk, lp, rk, rp, left_valid=l_valid, right_valid=r_valid, keys31=keys31,
            )
        return join_shard(lk, lp, rk, rp, left_valid=l_valid, right_valid=r_valid, impl=impl)

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


def _on_device(ds: DeviceSet, a):
    """A host numpy array or a tensor, on ds's device."""
    if isinstance(a, np.ndarray):
        return ds.scatter(a)
    return a.to(ds.device)


def dist_join(
    ds: DeviceSet,
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
    """Run the partitioned join of uint32 columns (host numpy arrays or
    tensors on ds's device). Returns padded outputs (fk, left_cols,
    right_cols, matched, overflow): both sides co-shuffled into
    nr_devices * rounds partitions, then joined (join_shuffled). rounds > 1
    joins the data as that many resident partition rounds. The JAX
    package's per-device program (``dist_join_spmd``) returns with the
    multi-device exchange (ROADMAP §1, "Multi-device")."""
    n_dev = ds.nr_devices
    left_fk, right_pk = _on_device(ds, left_fk), _on_device(ds, right_pk)
    left_payloads = tuple(_on_device(ds, p) for p in left_payloads)
    right_payloads = tuple(_on_device(ds, p) for p in right_payloads)
    slack = FLAGS.shuffle_slack
    cell_left = cell_left or default_cell_size(left_fk.shape[0] // n_dev, n_dev * rounds, slack)
    cell_right = cell_right or default_cell_size(right_pk.shape[0] // n_dev, n_dev * rounds, slack)
    right = shuffle_partitions(right_pk, right_payloads, n_dev, cell_right, rounds=rounds)
    left = shuffle_partitions(left_fk, left_payloads, n_dev, cell_left, rounds=rounds)
    return join_shuffled(left, right, impl=impl, keys31=keys31)


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

    Each prefix is one CUDA graph of k and of 2k chained steps. Payload
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

    def frag_body(lf, rk):
        lf, rk = sides(lf, rk)
        ck_l, cp_l, cnt_l, ovf_l = local_fragments(
            lf, planes(lf, n_left_payloads), n_dev * rounds, cell_left)
        ck_r, cp_r, cnt_r, ovf_r = local_fragments(
            rk, planes(rk, n_right_payloads), n_dev * rounds, cell_right)
        chk = (low([ck_l], 1) + low([ck_r], 3) + s64(cnt_l, cnt_r, ovf_l, ovf_r)
               + low([*cp_l, *cp_r], 7))
        return fold(lf, chk)

    def shuffled(lf, rk):
        lf, rk = sides(lf, rk)
        right = shuffle_partitions(rk, planes(rk, n_right_payloads), n_dev, cell_right,
                                   rounds=rounds)
        left = shuffle_partitions(lf, planes(lf, n_left_payloads), n_dev, cell_left,
                                  rounds=rounds)
        return left, right

    def shuf_body(lf, rk):
        left, right = shuffled(lf, rk)
        chk = (low([left.keys], 1) + low([right.keys], 3)
               + s64(left.counts, right.counts, left.overflow, right.overflow)
               + low([*left.payloads, *right.payloads], 7))
        return fold(lf, chk)

    def join_body(lf, rk):
        left, right = shuffled(lf, rk)
        fk, lcols, rcols, matched, overflow = join_shuffled(left, right, impl=impl, keys31=keys31)
        chk = low([fk], 1) + s64(matched, overflow) + low([*lcols, *rcols], 3)
        return fold(lf, chk)

    lf, rk = _on_device(ds, left_fk), _on_device(ds, right_pk)
    phases = {}
    prev = 0.0
    for name, body in (("fragments", frag_body), ("exchange", shuf_body),
                       ("local-join", join_body)):
        sec = time_chained(body, lf, k=k, consts=(rk,), graph=impl != "cuckoo")
        phases[f"{name}-ms"] = sec * 1e3 - prev
        prev = sec * 1e3
    return phases
