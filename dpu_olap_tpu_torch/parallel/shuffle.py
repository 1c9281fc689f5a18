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

The set gives the exchange (``DeviceSet.exchange`` is ``exchange``). Over a
process group (``parallel/process_group.py``: one process a device, the
counterpart of the JAX package under ``jax.distributed``) a ``GroupSet``
holds its rank's one shard, and its exchange is ``exchange_group``, one
``all_to_all_single``: the same blocks and the same layout, so the
fragments, the stacking and the unstacking around it are the same code.

Layout after the exchange: (P, cell_size) rows where row p holds the
fragment source-device p contributed to *my* partition, plus counts[p].
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..metrics import count, trace
from ..ops.partition_cuda import partition_cells, partition_cells_ref, partitionable
from .mesh import DeviceSet

LANES = 128  # the in-band counts' tail column (the JAX package's LANES_)
# What the exchanges move is counted in the program's counters
# (metrics.count): ``exchange.copies``, the copies issued (one a destination
# where its sources share its physical device, one a source and destination
# otherwise); ``exchange.bytes``, the bytes that reached the destinations;
# ``exchange.collectives``, the collectives exchange_group called (one a
# rank's call). The JAX package counts collectives in the compiled program
# (scripts/bench_multichip.py collective_count); these take their place.


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
    d = len(blocks)
    out = []
    for t, dst in enumerate(b.device for b in blocks):
        pieces = [b.chunk(d, dim=split_axis)[t] for b in blocks]
        if all(p.device == dst for p in pieces):
            recv = torch.cat(pieces, dim=concat_axis)
            count("exchange.copies")
        else:
            recv = _peer_copy(pieces, dst, concat_axis)
            count("exchange.copies", d)
        count("exchange.bytes", recv.numel() * recv.element_size())
        out.append(recv)
    return tuple(out)


def exchange_group(block: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """The tiled all-to-all over a process group (a ``GroupSet``, whose
    ``exchange`` this is): this
    rank's block is cut into world equal slices along axis, slice t goes to
    rank t, and the slices from every rank come back concatenated in rank
    order along the same axis: the block ``exchange`` gives shard t. One
    ``all_to_all_single`` on the contiguous block with the axis first, at
    every world size (at world 1 too, where the one-controller shuffle
    takes the identity: one card's NCCL group has only that world). The
    block moves as it is; neither NCCL nor gloo moves uint32, and the
    shuffle sends int32 views."""
    import torch.distributed as dist

    send = block.movedim(axis, 0).contiguous()
    if send.shape[0] % group.world_size:
        raise ValueError(f"axis {axis} of {send.shape[0]} does not split over"
                         f" {group.world_size} ranks")
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group.group)
    count("exchange.collectives")
    count("exchange.copies")
    count("exchange.bytes", recv.numel() * recv.element_size())
    return recv.movedim(0, axis)


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


def move_fragments(ds, frags, cell_size: int, rounds: int = 1,
                   counts_inband: bool = False) -> Tuple[ShuffleResult, ...]:
    """ShuffleResults from the fragments (``local_fragments``' outputs) of
    each shard this process holds, moved by the set's exchange (ds, a
    DeviceSet or a GroupSet): the stacked key and payload planes, with the
    counts in their tail column (counts_inband) or in a second, tiny
    exchange. Runs in the span dpu_olap.dist.exchange."""
    with trace("dpu_olap.dist.exchange"):
        move = ds.exchange
        stacked = [_stacked(ck, cp) for ck, cp, _, _ in frags]
        if counts_inband:
            tails = []
            for st, (_, _, counts, _) in zip(stacked, frags):
                tail = torch.zeros((st.shape[0], st.shape[1], LANES), dtype=torch.int32,
                                   device=st.device)
                tail[:, 0, 0] = counts.view(torch.int32)
                tails.append(torch.cat([st, tail], dim=2))
            recv = move(tails)
            return tuple(_unstacked(r[:, :, :cell_size], r[:, 0, cell_size], f[3], rounds)
                         for r, f in zip(recv, frags))
        recv = move(stacked)
        recv_counts = move([f[2].view(torch.int32) for f in frags])
        return tuple(_unstacked(r, c, f[3], rounds) for r, c, f in zip(recv, recv_counts, frags))


def shuffle_partitions(
    keys,
    payloads: tuple,
    nr_partitions: int,
    cell_size: int,
    rounds: int = 1,
    counts_inband: bool | None = None,
    ds=None,
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
    result is the same.

    ``ds`` is the set whose exchange moves the blocks: by default a
    DeviceSet of the shards' devices. Over a process group it is the
    GroupSet, ``keys`` and each payload column the 1-tuple of this rank's
    shard, and the 1-tuple of this rank's ShuffleResult returns: result t of
    the one-controller form over the same shards."""
    if counts_inband is None:
        from ..config import FLAGS

        counts_inband = FLAGS.shuffle_counts_inband
    if isinstance(keys, torch.Tensor):
        if nr_partitions != 1:
            raise ValueError(
                f"one device's keys take nr_partitions 1, got {nr_partitions}: several devices"
                " pass a tuple of shards")
        (res,) = shuffle_partitions((keys,), tuple((p,) for p in payloads), 1, cell_size, rounds)
        return res
    ds = ds or DeviceSet([k.device for k in keys])
    d = ds.nr_devices
    if nr_partitions != d:
        raise ValueError(f"{d} shards take nr_partitions {d}, got {nr_partitions}")
    with trace("dpu_olap.dist.partition"):
        frags = [local_fragments(k, tuple(col[s] for col in payloads), d * rounds, cell_size)
                 for s, k in enumerate(keys)]
    if d == 1 and isinstance(ds, DeviceSet):
        # one device under one controller: the identity exchange (a group's
        # is a collective at every world size)
        ck, cp, counts, overflow = frags[0]
        return (ShuffleResult(keys=ck, payloads=tuple(cp), counts=counts,
                              overflow=overflow.reshape(1), rounds=rounds),)
    return move_fragments(ds, frags, cell_size, rounds, counts_inband)


def default_cell_size(local_rows: int, nr_partitions: int, slack: float) -> int:
    """Slack-padded fragment capacity, rounded up to 128 rows as in the JAX
    package (its 128-lane layout; the kernel here takes any cell, and the
    same rounding keeps both packages' cells alike)."""
    base = int(np.ceil(local_rows / nr_partitions * slack))
    return max(128, -(-base // 128) * 128)
