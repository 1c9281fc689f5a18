"""Filter operators (counterpart of ``dpu_olap_tpu/operators/filter_op.py``).

FilterGpu — the counterpart of FilterTpu, the reference's FilterDpu
(host/filter/filter_dpu.cc): rounds of d * rpr batches (d devices, rpr
batches a device) are stacked on the host (native.parallel_stack, the
threaded copy of the port's runtime), rpr copied to each device, compacted
there by one launch of the filter kernel over the device's concatenation,
and read back with per-batch counts that locate each batch's chunk (the
round's counts in one readback, then its kept values in one); host assembly
slices the chunks in batch order.

FilterNative — pyarrow compute, the differential oracle
(host/filter/filter_native.cc).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import native
from ..columnar import Table, to_numpy
from ..metrics import device_log
from ..ops.filter import FILTER_THRESHOLD, default_predicate, filter_compact
from ..parallel.mesh import DeviceSet
from ..parallel.streaming import round_geometry, stream_rounds
from ..timer import Timers, timed


class FilterGpu:
    """Streaming filter: rounds of batches flow through the kernel with a
    bounded number of rounds in flight (the reference's virtual-DPU outer
    loop, filter_dpu.cc:127-156); a round holds at most
    FLAGS.stream_round_rows rows on the device."""

    def __init__(self, ds: DeviceSet, table: Table, column: str = "a"):
        self.ds = ds
        self.table = table
        self.column = column
        self.timers = Timers()

    def Prepare(self):
        n = self.table[0].num_rows
        if any(b.num_rows != n for b in self.table):
            raise ValueError("FilterGpu needs batches of one length")
        self.rpr, self.n_rounds = round_geometry(len(self.table), self.ds.nr_devices, n)
        return self

    def Run(self) -> List[np.ndarray]:
        d, rpr = self.ds.nr_devices, self.rpr
        per_round = d * rpr

        def stage(r):
            # host staging: the native threaded stack of the round's batches
            # (a background thread, overlapped with the previous round's
            # device work)
            rows = [to_numpy(self.table[r * per_round + i][self.column])
                    for i in range(per_round)]
            return native.parallel_stack(rows)

        def dispatch(r, staged):
            out = []
            for x in self.ds.split(staged):  # (rpr, n) uint32 a device
                # The stable compaction of the concatenation is the
                # concatenation of the per-batch compactions, so one kernel
                # pass serves a device's batches; per-batch counts of the
                # same predicate locate each chunk.
                counts = default_predicate(x).sum(dim=1)
                padded, _total = filter_compact(x.reshape(-1))
                out.append((padded, counts))
            return out

        def collect(r, handle):
            # worker thread: only copies from the round's tensors, which
            # name their devices; only the kept prefixes are read back
            padded, counts = zip(*handle)
            counts_h = DeviceSet.gather(counts).reshape(d, rpr)
            kept = counts_h.sum(axis=1)
            flat_h = DeviceSet.gather(tuple(p[: int(k)] for p, k in zip(padded, kept)))
            device_log(f"filter round {r} result counts", counts_h)
            ends = np.cumsum(counts_h.reshape(-1))
            return [flat_h[e - c : e] for c, e in zip(counts_h.reshape(-1), ends)]

        round_chunks = stream_rounds(
            self.n_rounds, stage, dispatch, collect, timers=self.timers
        )
        return [c for chunks in round_chunks for c in chunks]

    def Timers(self):
        return self.timers


class FilterNative:
    """pyarrow oracle: v < 2^30 per batch (filter_native.cc:59)."""

    def __init__(self, table: Table, column: str = "a"):
        self.table = table
        self.column = column
        self.timers = Timers()

    def Prepare(self):
        import pyarrow as pa

        self._arrays = [pa.array(to_numpy(b[self.column])) for b in self.table]
        return self

    def Run(self) -> List[np.ndarray]:
        import pyarrow as pa
        import pyarrow.compute as pc

        thresh = pa.scalar(int(FILTER_THRESHOLD), pa.uint32())
        with timed(self.timers, "native-work"):
            return [
                pc.filter(arr, pc.less(arr, thresh)).to_numpy() for arr in self._arrays
            ]

    def Timers(self):
        return self.timers
