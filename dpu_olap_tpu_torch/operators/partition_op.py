"""Standalone partition operator (counterpart of
``dpu_olap_tpu/operators/partition_op.py``).

Reference: host/partition/partition_dpu.cc (non-functional in the
reference, README.md:114-118). PartitionGpu repartitions a table into P
global hash partitions, carrying its other columns, with one of two engines
(parallel/partitioner.py):
  * resident (the default when P is a multiple of the device count and the
    table fits the device): one shuffle; the partitions stay on the device
    as DevicePartitions (cells + counts) until ``to_host()``;
  * host-staged (Partitioner): a batch a device at a time through the
    devices, the partitions assembled on the host.
Over d devices the resident engine partitions each device's share into P
partitions and exchanges them, P / d to a device. Both launch the partition
kernel (csrc/partition.cu) for P a power of two in [2, 16], once a shard.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..columnar import Table
from ..parallel.mesh import DeviceSet
from ..parallel.partitioner import DevicePartitions, Partitioner, ResidentPartitioner
from ..timer import Timers


class PartitionGpu:
    # Resident ceiling: cells ~= rows * slack per column; beyond this the
    # host-staged engine streams rounds instead.
    MAX_RESIDENT_ROWS = 256 << 20

    def __init__(
        self,
        ds: DeviceSet,
        table: Table,
        key_col: str,
        nr_partitions: int,
        resident: bool | None = None,
    ):
        self.ds, self.table, self.key_col = ds, table, key_col
        self.nr_partitions = nr_partitions
        self.resident = resident
        self.timers = Timers()

    def Prepare(self):
        self.payload_cols = [c for c in self.table.names if c != self.key_col]
        d = self.ds.nr_devices
        if self.resident is None:
            self.resident = (
                self.nr_partitions % d == 0
                and self.table.num_rows % d == 0
                and self.table.num_rows <= self.MAX_RESIDENT_ROWS
            )
        engine = ResidentPartitioner if self.resident else Partitioner
        self._parter = engine(self.ds, self.nr_partitions, timers=self.timers)
        return self

    def Run(self) -> "DevicePartitions | List[Dict[str, np.ndarray]]":
        """Resident engine: DevicePartitions (on the device; .to_host() to
        materialize). Host-staged engine: a list of host partition dicts."""
        out = self._parter.partition_table(self.table, self.key_col, self.payload_cols)
        if isinstance(out, DevicePartitions):
            out.sync()
        return out

    def Timers(self):
        return self.timers
