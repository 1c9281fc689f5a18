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
(ROADMAP §1 item 10).

Output: padded rows (the local join's layout, round after round) + a
matched mask; the host compacts them (operators/join_op.py), as the
reference reassembles batches on the host (join_dpu.cc:371-399).
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
    multi-device exchange (ROADMAP §1 item 10)."""
    n_dev = ds.nr_devices

    def on_device(a):
        if isinstance(a, np.ndarray):
            return ds.scatter(a)
        return a.to(ds.device)

    left_fk, right_pk = on_device(left_fk), on_device(right_pk)
    left_payloads = tuple(on_device(p) for p in left_payloads)
    right_payloads = tuple(on_device(p) for p in right_payloads)
    slack = FLAGS.shuffle_slack
    cell_left = cell_left or default_cell_size(left_fk.shape[0] // n_dev, n_dev * rounds, slack)
    cell_right = cell_right or default_cell_size(right_pk.shape[0] // n_dev, n_dev * rounds, slack)
    right = shuffle_partitions(right_pk, right_payloads, n_dev, cell_right, rounds=rounds)
    left = shuffle_partitions(left_fk, left_payloads, n_dev, cell_left, rounds=rounds)
    return join_shuffled(left, right, impl=impl, keys31=keys31)
