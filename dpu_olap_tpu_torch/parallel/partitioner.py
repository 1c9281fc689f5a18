"""Partition engines (counterpart of ``dpu_olap_tpu/parallel/partitioner.py``).

Reference: host/partition/partitioner.{h,cc} + host/partition/partition.{h,cc}
— the DPUs radix-partition locally, the host reserves slots in global
Partition buffers (GetOffsets, partitioner.cc:280-312) and gathers the
fragments into them (LoadPartitions :350-375).

  * ``Partitioner``: the host-staged engine. Each round uploads one batch
    a device, lays its fragments into padded cells on that device
    (shuffle.local_fragments, the partition kernel), and the host reserves
    each cell's rows in its partition's ``native.PartitionSlab`` and copies
    them there through an ``native.OrderedExecutor`` (one queue a
    partition, at most 8), as the JAX engine does (partitioner.py:85-90,
    127-160): device by device, so a partition keeps the table's row order.
  * ``ResidentPartitioner``: the device-resident engine. One shuffle into
    nr_partitions partitions (over several devices, one exchange); they
    stay on the devices as ``DevicePartitions`` (cells + counts, the layout
    the shuffle join consumes) until ``to_host()``.

Over several devices the counts and overflow flags of a round are read back
together, once, and so are its cells.

Columns are read as uint32, as the JAX engine's slabs are
(partitioner.py:84).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import native
from ..columnar import Table, to_numpy
from ..config import FLAGS
from ..timer import timed
from .mesh import DeviceSet, sync_devices
from .shuffle import default_cell_size, local_fragments, shuffle_partitions
from .streaming import stream_rounds


def _u32(col) -> np.ndarray:
    return to_numpy(col).astype(np.uint32, copy=False)


class Partitioner:
    """Repartition a Table into nr_partitions global hash partitions,
    streaming its batches through the devices, one batch a device in each
    round."""

    def __init__(self, ds: DeviceSet, nr_partitions: int, timers=None):
        self.ds = ds
        self.nr_partitions = nr_partitions
        self.timers = timers

    def partition_table(
        self, table: Table, key_col: str, payload_cols: Sequence[str] = ()
    ) -> List[Dict[str, np.ndarray]]:
        """Returns one dict of host uint32 columns per global partition."""
        d = self.ds.nr_devices
        if len(table) % d:
            raise ValueError(f"{len(table)} batches do not divide over {d} devices")
        p = self.nr_partitions
        slack = FLAGS.shuffle_slack
        cell = default_cell_size(table[0].num_rows, p, slack)
        names = [key_col, *payload_cols]
        # a batch puts at most a cell in each partition (more raises below),
        # so a slab of a cell a batch holds any key skew
        cap = len(table) * cell
        slabs = [native.PartitionSlab([np.uint32] * len(names), cap) for _ in range(p)]
        executor = native.OrderedExecutor(min(8, p))

        def stage(r):
            return [[_u32(table[r * d + i][c]) for c in names] for i in range(d)]

        def dispatch(r, staged):
            frags = []
            for dev, cols in zip(self.ds.devices, staged):
                keys, *pays = (torch.from_numpy(a).to(dev) for a in cols)
                frags.append(local_fragments(keys, tuple(pays), p, cell))
            return frags

        def collect(r, handle):
            # worker thread: only copies from the round's tensors, which
            # name their devices; each of counts, flags and cells is one
            # readback for the round's devices
            ck, cp, counts, overflow = zip(*handle)
            if DeviceSet.gather(tuple(o.reshape(1) for o in overflow)).any():
                raise OverflowError("partition fragment exceeded cell size; raise shuffle_slack")
            counts_h = DeviceSet.gather(counts).reshape(d, p)
            cols = [DeviceSet.gather(ck).reshape(d, p, -1)] + [
                DeviceSet.gather(x).reshape(d, p, -1) for x in zip(*cp)]
            for dev in range(d):
                for part in range(p):
                    c = int(counts_h[dev, part])
                    if c:
                        start = slabs[part].reserve(c)
                        for ci, col in enumerate(cols):
                            executor.submit_partition_write(
                                part, slabs[part], ci, col[dev, part, :c], start)

        stream_rounds(len(table) // d, stage, dispatch, collect, timers=self.timers)
        executor.sync()
        return [
            {nm: np.array(slab.column(i)) for i, nm in enumerate(names)} for slab in slabs
        ]


@dataclasses.dataclass
class DevicePartitions:
    """Device-resident global hash partitions in padded-cell form.

    Global partition p lives on device p // rounds as ``d`` source
    fragments: the leading dim is d * (d * rounds), device t owns rows
    [t*d*rounds, (t+1)*d*rounds), and within that block row s*rounds + r is
    source device s's fragment of partition t*rounds + r — the
    (cells, counts) layout the shuffle join consumes (shuffle.ShuffleResult).
    Each field is a tuple of shards, shard t device t's block (or one
    tensor of every block). Nothing leaves the devices unless to_host() is
    called.
    """

    keys: tuple  # d shards of (d * rounds, cell) uint32
    payloads: tuple  # each like keys
    counts: tuple  # d shards of (d * rounds,) uint32
    names: list  # column names, [key_col, *payload_cols]
    nr_partitions: int
    rounds: int  # partitions per device

    def sync(self) -> None:
        """Completion barrier on the partitions' devices."""
        shards = self.keys if isinstance(self.keys, tuple) else (self.keys,)
        sync_devices([s.device for s in shards])

    def partition_rows(self) -> np.ndarray:
        """True row count per global partition ((P,) host array; one
        readback)."""
        counts = DeviceSet.gather(self.counts)
        d = counts.shape[0] // self.nr_partitions
        c = counts.reshape(-1, d, self.rounds)  # (t, s, r)
        return c.transpose(0, 2, 1).reshape(self.nr_partitions, d).sum(1)

    def to_host(self) -> List[Dict[str, np.ndarray]]:
        """Host partitions, one dict per global partition: the
        Partitioner.partition_table contract."""
        counts = DeviceSet.gather(self.counts).reshape(-1)
        d = counts.shape[0] // self.nr_partitions  # source devices
        cols = [DeviceSet.gather(self.keys)] + [DeviceSet.gather(x) for x in self.payloads]
        out: List[Dict[str, np.ndarray]] = []
        for p in range(self.nr_partitions):
            t, rr = divmod(p, self.rounds)
            rows = [t * d * self.rounds + s * self.rounds + rr for s in range(d)]
            out.append({
                nm: np.concatenate([col[row, : int(counts[row])] for row in rows])
                for nm, col in zip(self.names, cols)
            })
        return out


class ResidentPartitioner:
    """Repartition device-resident columns into nr_partitions global
    partitions with one shuffle and no host staging. nr_partitions must be a
    positive multiple of the device count."""

    def __init__(self, ds: DeviceSet, nr_partitions: int, timers=None):
        assert nr_partitions % ds.nr_devices == 0 and nr_partitions > 0
        self.ds = ds
        self.nr_partitions = nr_partitions
        self.rounds = nr_partitions // ds.nr_devices
        self.timers = timers

    def partition_arrays(self, keys, payloads: tuple, names: List[str]) -> DevicePartitions:
        """keys/payloads: 1-D uint32 host arrays or tensors, rows divisible
        by the device count, split one shard a device."""
        d = self.ds.nr_devices
        n = keys.shape[0]
        if n % d:
            raise ValueError(f"{n} rows do not split over {d} devices")
        cell = default_cell_size(n // d, self.nr_partitions, FLAGS.shuffle_slack)
        keys = self.ds.split(keys)
        payloads = tuple(self.ds.split(p) for p in payloads)
        with timed(self.timers, "partition-resident"):
            res = shuffle_partitions(keys, payloads, d, cell, rounds=self.rounds)
            # every device's flag in one readback
            if DeviceSet.gather(tuple(r.overflow for r in res)).any():
                raise OverflowError("partition fragment exceeded cell size; raise shuffle_slack")
        return DevicePartitions(
            keys=tuple(r.keys for r in res),
            payloads=tuple(zip(*(r.payloads for r in res))),
            counts=tuple(r.counts for r in res),
            names=names,
            nr_partitions=self.nr_partitions,
            rounds=self.rounds,
        )

    def partition_table(
        self, table: Table, key_col: str, payload_cols: Sequence[str] = ()
    ) -> DevicePartitions:
        cols = [key_col, *payload_cols]
        keys = np.concatenate([_u32(b[key_col]) for b in table])
        pays = tuple(np.concatenate([_u32(b[c]) for b in table]) for c in payload_cols)
        return self.partition_arrays(keys, pays, cols)
