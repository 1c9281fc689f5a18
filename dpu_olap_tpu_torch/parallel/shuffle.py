"""Hash-partition shuffle into padded cells (counterpart of
``dpu_olap_tpu/parallel/shuffle.py``).

Reference: host/partition/partitioner.{h,cc} — each DPU radix-partitions its
batch locally and the host gathers every DPU's fragments into global
partition buffers. As in the JAX package, each (source device -> target
partition) fragment rides in a fixed-size *cell* of ``cell_size`` rows
(slack-padded, FLAGS.shuffle_slack; the reference over-allocates partitions
1.5-2x, join_dpu.cc:97-100) with a true-count vector, and cell overflow is
reported like the reference's Partition::Write throw (partition.cc:19-26).

This slice runs on one device, where the exchange is the identity: the
local fragments are what the device receives. The all-to-all over several
devices (a process group, NCCL) is ROADMAP §1 item 10; ``shuffle_partitions``
raises for more than one device until then.

Layout after the exchange: (P, cell_size) rows where row p holds the
fragment source-device p contributed to *my* partition, plus counts[p].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.partition_cuda import partition_cells, partition_cells_ref, partitionable


@dataclasses.dataclass
class ShuffleResult:
    """Per-device padded partition fragments.

    rounds == 1: leading dim = source device, (P, cell).
    rounds == R > 1 (the device-resident multi-round form): row s*R + r is
    the fragment source-device s contributed to MY round-r partition; use
    round_planes() to regroup into per-round (R, d*cell) planes.
    """

    keys: torch.Tensor  # (P, cell) uint32, EMPTY in padded lanes
    payloads: Tuple[torch.Tensor, ...]  # each (P, cell) uint32
    counts: torch.Tensor  # (P,) uint32 true fragment lengths
    overflow: torch.Tensor  # bool (1,): some fragment exceeded cell_size
    rounds: int = 1

    def _valid(self) -> torch.Tensor:
        cell = self.keys.shape[1]
        lane = torch.arange(cell, device=self.keys.device)
        return lane < self.counts.to(torch.int64)[:, None]

    def flat(self):
        """Fragments flattened to 1-D (n,) arrays + validity mask."""
        return (
            self.keys.reshape(-1),
            tuple(x.reshape(-1) for x in self.payloads),
            self._valid().reshape(-1),
        )

    def round_planes(self):
        """(keys (R, d*cell), payloads each (R, d*cell), valid (R, d*cell)):
        the per-round planes the resident join loops over."""
        p, cell = self.keys.shape
        r = self.rounds
        d = p // r

        def regroup(x):
            return x.reshape(d, r, cell).transpose(0, 1).reshape(r, d * cell)

        def regroup_u32(x):  # moved as int32 bit patterns
            return regroup(x.view(torch.int32)).view(torch.uint32)

        return (
            regroup_u32(self.keys),
            tuple(regroup_u32(x) for x in self.payloads),
            regroup(self._valid()),
        )


def local_fragments(
    keys: torch.Tensor,
    payloads: Tuple[torch.Tensor, ...],
    nr_partitions: int,
    cell_size: int,
):
    """Partition one device's batch and lay fragments into fixed cells.

    Returns (cells_keys (P, cell), cells_payloads, counts (P,), overflow
    0-d bool): the kernel_partition equivalent (partition.c) with the
    metadata staying on the device. Keys and payloads are uint32; padded
    lanes hold key EMPTY and payload 0.

    The partition kernel (ops/partition_cuda.py) serves every call where the
    JAX package's kernel gate holds for the function: P a power of two in
    [2, 16] (shuffle.py:122-129). Otherwise, as in the JAX package, the
    radix partition's stable sort and a gather lay the cells: the kernel's
    plain version, which the kernel is held to."""
    keys = keys.reshape(-1)
    payloads = tuple(p.reshape(-1) for p in payloads)
    partition = partition_cells if partitionable(nr_partitions) else partition_cells_ref
    ck, cp, _sel, counts, overflow = partition(
        keys, payloads, nr_partitions, cell_size, with_sel=False
    )
    return ck, cp, counts, overflow


def shuffle_partitions(
    keys: torch.Tensor,
    payloads: Tuple[torch.Tensor, ...],
    nr_partitions: int,
    cell_size: int,
    rounds: int = 1,
) -> ShuffleResult:
    """Local partition -> exchange, with nr_partitions the number of devices.

    rounds > 1 is the device-resident multi-round form (the reference's
    virtual-DPU rounds, join_dpu.cc:191,254, without the host bounce): keys
    bucket into nr_partitions*rounds partitions, bucket q targets device
    q // rounds, local round q % rounds, and each device then owns `rounds`
    resident partitions to join one after another
    (ShuffleResult.round_planes). On one device the exchange is the
    identity: the received cells and counts are the local ones."""
    if nr_partitions != 1:
        raise NotImplementedError(
            "the multi-device shuffle exchange is not ported yet (ROADMAP §1 item 10)"
        )
    ck, cp, counts, overflow = local_fragments(keys, payloads, nr_partitions * rounds, cell_size)
    return ShuffleResult(
        keys=ck,
        payloads=tuple(cp),
        counts=counts,
        overflow=overflow.reshape(1),
        rounds=rounds,
    )


def default_cell_size(local_rows: int, nr_partitions: int, slack: float) -> int:
    """Slack-padded fragment capacity, rounded up to 128 rows as in the JAX
    package (its 128-lane layout; the kernel here takes any cell, and the
    same rounding keeps both packages' cells alike)."""
    base = int(np.ceil(local_rows / nr_partitions * slack))
    return max(128, -(-base // 128) * 128)
