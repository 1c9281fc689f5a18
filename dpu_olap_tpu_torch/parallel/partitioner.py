"""Partition engines (counterpart of ``dpu_olap_tpu/parallel/partitioner.py``).

Reference: host/partition/partitioner.{h,cc} + host/partition/partition.{h,cc}
— the DPUs radix-partition locally, the host reserves slots in global
Partition buffers (GetOffsets, partitioner.cc:280-312) and gathers the
fragments into them (LoadPartitions :350-375).

  * ``Partitioner``: the host-staged engine. Each round uploads one batch,
    lays its fragments into padded cells on the device
    (shuffle.local_fragments, the partition kernel) and appends each cell's
    rows to its host partition. The JAX package assembles the partitions
    with its native runtime when that is built; the port has no native
    runtime yet (ROADMAP §1 item 1) and takes the JAX package's pure-Python
    branch (partitioner.py:89-90, 141-148).
  * ``ResidentPartitioner``: the device-resident engine. One shuffle into
    nr_partitions partitions; they stay on the device as
    ``DevicePartitions`` (cells + counts, the layout the shuffle join
    consumes) until ``to_host()``.

Columns are read as uint32, as the JAX engine's slabs are
(partitioner.py:84).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..columnar import Table, to_numpy
from ..config import FLAGS
from ..timer import timed
from .mesh import DeviceSet
from .shuffle import default_cell_size, local_fragments, shuffle_partitions
from .streaming import stream_rounds


def _u32(col) -> np.ndarray:
    return to_numpy(col).astype(np.uint32, copy=False)


class Partitioner:
    """Repartition a Table into nr_partitions global hash partitions,
    streaming its batches through the device one round each."""

    def __init__(self, ds: DeviceSet, nr_partitions: int, timers=None):
        self.ds = ds
        self.nr_partitions = nr_partitions
        self.timers = timers

    def partition_table(
        self, table: Table, key_col: str, payload_cols: Sequence[str] = ()
    ) -> List[Dict[str, np.ndarray]]:
        """Returns one dict of host uint32 columns per global partition."""
        p = self.nr_partitions
        cell = default_cell_size(table[0].num_rows, p, FLAGS.shuffle_slack)
        names = [key_col, *payload_cols]
        parts: List[List[List[np.ndarray]]] = [[[] for _ in names] for _ in range(p)]

        def stage(r):
            return [_u32(table[r][c]) for c in names]

        def dispatch(r, staged):
            keys, *pays = (self.ds.scatter(a) for a in staged)
            return local_fragments(keys, tuple(pays), p, cell)

        def collect(r, handle):
            # worker thread: only copies from the round's tensors, which
            # name their device
            ck, cp, counts, overflow = handle
            if bool(overflow.cpu()):
                raise OverflowError("partition fragment exceeded cell size; raise shuffle_slack")
            counts_h = counts.cpu().numpy()
            cols = [ck.cpu().numpy()] + [x.cpu().numpy() for x in cp]
            for part in range(p):
                c = int(counts_h[part])
                if c:
                    for dst, col in zip(parts[part], cols):
                        dst.append(col[part, :c])

        stream_rounds(len(table), stage, dispatch, collect, timers=self.timers)
        empty = np.empty(0, np.uint32)
        return [
            {nm: np.concatenate(chunks) if chunks else empty for nm, chunks in zip(names, cols)}
            for cols in parts
        ]


@dataclasses.dataclass
class DevicePartitions:
    """Device-resident global hash partitions in padded-cell form.

    Global partition p lives on device p // rounds as ``d`` source
    fragments: the leading dim is d * (d * rounds), device t owns rows
    [t*d*rounds, (t+1)*d*rounds), and within that block row s*rounds + r is
    source device s's fragment of partition t*rounds + r — the
    (cells, counts) layout the shuffle join consumes (shuffle.ShuffleResult).
    Nothing leaves the device unless to_host() is called.
    """

    keys: torch.Tensor  # (d * d * rounds, cell) uint32
    payloads: tuple  # each like keys
    counts: torch.Tensor  # (d * d * rounds,) uint32
    names: list  # column names, [key_col, *payload_cols]
    nr_partitions: int
    rounds: int  # partitions per device

    def sync(self) -> None:
        """Completion barrier on the partitions' device."""
        if self.keys.device.type == "cuda":
            torch.cuda.synchronize(self.keys.device)

    def partition_rows(self) -> np.ndarray:
        """True row count per global partition ((P,) host array)."""
        d = self.keys.shape[0] // self.nr_partitions
        c = self.counts.cpu().numpy().reshape(-1, d, self.rounds)  # (t, s, r)
        return c.transpose(0, 2, 1).reshape(self.nr_partitions, d).sum(1)

    def to_host(self) -> List[Dict[str, np.ndarray]]:
        """Host partitions, one dict per global partition: the
        Partitioner.partition_table contract."""
        d = self.keys.shape[0] // self.nr_partitions  # source devices
        counts = self.counts.cpu().numpy().reshape(-1)
        cols = [self.keys.cpu().numpy()] + [x.cpu().numpy() for x in self.payloads]
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
        """keys/payloads: 1-D uint32 host arrays or tensors on ds's device,
        rows divisible by the device count."""
        d = self.ds.nr_devices
        n = keys.shape[0]
        assert n % d == 0
        cell = default_cell_size(n // d, self.nr_partitions, FLAGS.shuffle_slack)
        if isinstance(keys, np.ndarray):
            keys = self.ds.scatter(keys)
            payloads = tuple(self.ds.scatter(p) for p in payloads)
        with timed(self.timers, "partition-resident"):
            res = shuffle_partitions(keys, tuple(payloads), d, cell, rounds=self.rounds)
            if bool(res.overflow.any()):
                raise OverflowError("partition fragment exceeded cell size; raise shuffle_slack")
        return DevicePartitions(
            keys=res.keys,
            payloads=tuple(res.payloads),
            counts=res.counts,
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
