"""Take operators (counterpart of ``dpu_olap_tpu/operators/take_op.py``).

TakeGpu — the counterpart of TakeTpu, the reference's TakeDpu
(host/take/take_dpu.cc:34-104): per round, stack d * rpr batches of data and
indices on the host (native.parallel_stack), copy rpr to each of the d
devices and gather there; the host reads the round's outputs back in one
readback and splits them per batch.

TakeNative — arrow::compute::Take per batch (host/take/take_native.cc:18-38).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import native
from ..columnar import Table, to_numpy
from ..ops.take import take
from ..ops.take_cuda import take_sorted, takeable_sorted
from ..parallel.mesh import DeviceSet
from ..parallel.streaming import round_geometry, stream_rounds
from ..timer import Timers, timed


class TakeGpu:
    """Streaming take: rounds of batch pairs with a bounded number of
    rounds in flight (the take_dpu.cc:62-91 round loop + async pipeline).

    A round's rpr batches run as ONE take over their concatenated table,
    each batch's clipped indices offset by its start row. A 4-byte data
    column takes the sorted-stream program (sort kernel, gather kernel,
    restore sort; ops/take_cuda.take_sorted); other widths take the row
    gather (ops/take.take). The gather has no window, so its overflow flag
    is always 0: a flag that is not 0 raises."""

    def __init__(self, ds: DeviceSet, data: Table, indices: Table,
                 data_col: str = "a", idx_col: str = "i"):
        self.ds, self.data, self.indices = ds, data, indices
        self.data_col, self.idx_col = data_col, idx_col
        self.timers = Timers()

    def Prepare(self):
        if len(self.data) != len(self.indices):
            raise ValueError("TakeGpu needs one index batch per data batch")
        n = self.data[0].num_rows
        k = self.indices[0].num_rows
        if any(b.num_rows != n for b in self.data) or any(
            b.num_rows != k for b in self.indices
        ):
            raise ValueError("TakeGpu needs data batches of one length and index batches of one length")
        self.rpr, self.n_rounds = round_geometry(len(self.data), self.ds.nr_devices, n)
        itemsize = to_numpy(self.data[0][self.data_col]).dtype.itemsize
        self._use_sorted = itemsize == 4 and takeable_sorted(self.rpr * n, self.rpr * k)
        return self

    def _take_round(self, data: torch.Tensor, idx: torch.Tensor):
        """data (rpr, n), idx (rpr, k) -> (out (rpr, k), overflow flag)."""
        rpr, n = data.shape
        k = idx.shape[1]
        offs = torch.arange(rpr, device=data.device).reshape(rpr, 1) * n
        q = (idx.to(torch.int64) & 0xFFFFFFFF).clamp(max=n - 1) + offs
        if self._use_sorted:
            out, flag = take_sorted(data.reshape(-1), q.reshape(-1).to(torch.uint32))
        else:
            out, flag = take(data.reshape(-1), q.reshape(-1)), None
        return out.reshape(rpr, k), flag

    def Run(self) -> List[np.ndarray]:
        per_round = self.ds.nr_devices * self.rpr
        k = self.indices[0].num_rows

        def stage(r):
            batches = range(r * per_round, (r + 1) * per_round)
            data = native.parallel_stack([to_numpy(self.data[i][self.data_col]) for i in batches])
            idx = native.parallel_stack([to_numpy(self.indices[i][self.idx_col]) for i in batches])
            return data, idx

        def dispatch(r, staged):
            data, idx = staged
            return [self._take_round(x, i)
                    for x, i in zip(self.ds.split(data), self.ds.split(idx))]

        def collect(r, handle):
            out, flags = zip(*handle)
            if self._use_sorted and DeviceSet.gather(tuple(f.reshape(1) for f in flags)).any():
                raise RuntimeError("take_sorted reported a gather overflow")
            return list(DeviceSet.gather(out).reshape(-1, k))

        rounds = stream_rounds(self.n_rounds, stage, dispatch, collect, timers=self.timers)
        return [c for chunk in rounds for c in chunk]

    def Timers(self):
        return self.timers


class TakeNative:
    def __init__(self, data: Table, indices: Table, data_col: str = "a", idx_col: str = "i"):
        self.data, self.indices = data, indices
        self.data_col, self.idx_col = data_col, idx_col
        self.timers = Timers()

    def Prepare(self):
        import pyarrow as pa

        self._data = [pa.array(to_numpy(b[self.data_col])) for b in self.data]
        self._idx = [pa.array(to_numpy(b[self.idx_col])) for b in self.indices]
        return self

    def Run(self) -> List[np.ndarray]:
        import pyarrow.compute as pc

        with timed(self.timers, "native-work"):
            return [pc.take(d, i).to_numpy() for d, i in zip(self._data, self._idx)]

    def Timers(self):
        return self.timers
