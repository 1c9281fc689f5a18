"""Hash-partition shuffle into padded cells (counterpart of
``dpu_olap_tpu/parallel/shuffle.py``).

Reference: host/partition/partitioner.{h,cc} — each DPU radix-partitions its
batch locally and the host gathers every DPU's fragments into global
partition buffers. As in the JAX package, each (source device -> target
partition) fragment rides in a fixed-size *cell* of ``cell_size`` rows
(slack-padded, FLAGS.shuffle_slack; the reference over-allocates partitions
1.5-2x, join_dpu.cc:97-100) with a true-count vector, and cell overflow is
reported like the reference's Partition::Write throw (partition.cc:19-26).

On one device the exchange is the identity: the local fragments are what
the device receives. Over several devices (a DeviceSet's shards, one
controller) each shard lays its fragments (``local_fragments``) and one
``exchange`` moves them: destination t takes rows [t*rounds, (t+1)*rounds)
of every source's cells, in source order, as the JAX package's one tiled
``lax.all_to_all`` does (shuffle.py:199-205). The key and payload planes
travel stacked, so a source sends each destination one copy; the counts
travel in a second, tiny exchange or, with FLAGS.shuffle_counts_inband, in a
128-lane tail column of the stacked cells. The exchange is a ``torch.cat``
of views where source and destination are one physical device and a peer
copy (``copy_`` with ``non_blocking``) otherwise: ordered on both devices'
current streams, so the destination's later work runs after it. XLA's
collective is not a Pallas kernel, and the exchange is no kernel either.

Layout after the exchange: (P, cell_size) rows where row p holds the
fragment source-device p contributed to *my* partition, plus counts[p].
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.partition_cuda import partition_cells, partition_cells_ref, partitionable

LANES = 128  # the in-band counts' tail column (the JAX package's LANES_)
# What the exchanges moved since the counts were last set to 0: copies
# issued (one a destination where its sources share its physical device, one
# a source and destination otherwise) and the bytes that reached the
# destinations. The JAX package counts collectives in the compiled program
# (scripts/bench_multichip.py collective_count); these take their place.
COPIES = 0
BYTES = 0


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


def exchange(blocks: Sequence[torch.Tensor], split_axis: int = 0,
             concat_axis: int = 0) -> tuple:
    """The tiled all-to-all over a DeviceSet's shards
    (``lax.all_to_all(..., tiled=True)``): blocks[s] lies on source s's
    device; destination t, on blocks[t]'s device, receives the t-th of d
    equal slices of every blocks[s] along split_axis, concatenated in source
    order along concat_axis. Blocks move as they are (the shuffle sends int32
    views of its uint32 planes)."""
    global COPIES, BYTES
    d = len(blocks)
    out = []
    for t, dst in enumerate(b.device for b in blocks):
        pieces = [b.chunk(d, dim=split_axis)[t] for b in blocks]
        if all(p.device == dst for p in pieces):
            recv = torch.cat(pieces, dim=concat_axis)
            COPIES += 1
        else:
            recv = _peer_copy(pieces, dst, concat_axis)
            COPIES += d
        BYTES += recv.numel() * recv.element_size()
        out.append(recv)
    return tuple(out)


def _peer_copy(pieces, dst: torch.device, axis: int) -> torch.Tensor:
    """The pieces concatenated along axis into a new tensor on dst, one
    asynchronous copy a piece (a peer copy from another device)."""
    shape = list(pieces[0].shape)
    shape[axis] = sum(p.shape[axis] for p in pieces)
    recv = torch.empty(shape, dtype=pieces[0].dtype, device=dst)
    for part, piece in zip(recv.split([p.shape[axis] for p in pieces], dim=axis), pieces):
        part.copy_(piece, non_blocking=True)
    return recv


def _stacked(ck, cp) -> torch.Tensor:
    """A device's cells and payload cells as one (P, planes, cell) int32
    block (uint32 bit patterns: the stack and the exchange move int32)."""
    return torch.stack([x.view(torch.int32) for x in (ck, *cp)], dim=1)


def _unstacked(recv: torch.Tensor, counts: torch.Tensor, overflow, rounds: int) -> ShuffleResult:
    planes = recv.view(torch.uint32)
    return ShuffleResult(
        keys=planes[:, 0],
        payloads=tuple(planes[:, 1 + i] for i in range(planes.shape[1] - 1)),
        counts=counts.view(torch.uint32),
        overflow=overflow.reshape(1),
        rounds=rounds,
    )


def shuffle_partitions(
    keys,
    payloads: tuple,
    nr_partitions: int,
    cell_size: int,
    rounds: int = 1,
    counts_inband: bool | None = None,
):
    """Local partition -> exchange, with nr_partitions the number of devices.

    One device: ``keys`` is a tensor, ``payloads`` a tuple of tensors and
    nr_partitions 1; the exchange is the identity and one ShuffleResult
    returns. Several devices: ``keys`` is a tuple of d shards (shard s on
    source device s), each payload column a tuple of d shards, nr_partitions
    d; each shard lays its fragments and one exchange moves them, and a
    tuple of d ShuffleResults returns, result t on device t (the JAX
    package's global arrays, device block by device block).

    rounds > 1 is the device-resident multi-round form (the reference's
    virtual-DPU rounds, join_dpu.cc:191,254, without the host bounce): keys
    bucket into nr_partitions*rounds partitions, bucket q targets device
    q // rounds, local round q % rounds, and each device then owns `rounds`
    resident partitions to join one after another
    (ShuffleResult.round_planes). ``counts_inband`` (FLAGS.shuffle_counts_
    inband by default) moves the counts in the cells' tail column; the
    result is the same."""
    if isinstance(keys, torch.Tensor):
        if nr_partitions != 1:
            raise ValueError(
                f"one device's keys take nr_partitions 1, got {nr_partitions}: several devices"
                " pass a tuple of shards")
        (res,) = shuffle_partitions((keys,), tuple((p,) for p in payloads), 1, cell_size, rounds)
        return res
    d = len(keys)
    if nr_partitions != d:
        raise ValueError(f"{d} shards take nr_partitions {d}, got {nr_partitions}")
    if counts_inband is None:
        from ..config import FLAGS

        counts_inband = FLAGS.shuffle_counts_inband
    frags = [local_fragments(keys[s], tuple(col[s] for col in payloads), d * rounds, cell_size)
             for s in range(d)]
    if d == 1:  # the identity exchange
        ck, cp, counts, overflow = frags[0]
        return (ShuffleResult(keys=ck, payloads=tuple(cp), counts=counts,
                              overflow=overflow.reshape(1), rounds=rounds),)
    stacked = [_stacked(ck, cp) for ck, cp, _, _ in frags]
    if counts_inband:
        tails = []
        for st, (_, _, counts, _) in zip(stacked, frags):
            tail = torch.zeros((st.shape[0], st.shape[1], LANES), dtype=torch.int32,
                               device=st.device)
            tail[:, 0, 0] = counts.view(torch.int32)
            tails.append(torch.cat([st, tail], dim=2))
        recv = exchange(tails)
        return tuple(_unstacked(r[:, :, :cell_size], r[:, 0, cell_size], f[3], rounds)
                     for r, f in zip(recv, frags))
    recv = exchange(stacked)
    recv_counts = exchange([f[2].view(torch.int32) for f in frags])
    return tuple(_unstacked(r, c, f[3], rounds) for r, c, f in zip(recv, recv_counts, frags))


def default_cell_size(local_rows: int, nr_partitions: int, slack: float) -> int:
    """Slack-padded fragment capacity, rounded up to 128 rows as in the JAX
    package (its 128-lane layout; the kernel here takes any cell, and the
    same rounding keeps both packages' cells alike)."""
    base = int(np.ceil(local_rows / nr_partitions * slack))
    return max(128, -(-base // 128) * 128)
