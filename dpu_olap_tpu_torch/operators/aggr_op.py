"""Sum-aggregate operators (counterpart of ``dpu_olap_tpu/operators/aggr_op.py``).

SumGpu — the counterpart of SumTpu, the reference's SumDpu
(host/aggr/aggr_dpu.cc:31-89): per round, stack d * rpr batches on the host
(native.parallel_stack), copy rpr to each of the d devices and reduce them
there; the host adds the devices' and rounds' exact partials
(aggr_dpu.cc:82-84), each round's read back in one readback.

SumNative — pyarrow sum, the oracle (host/aggr/aggr_native.cc).
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..columnar import Table, to_numpy
from ..ops.aggregate import sum_f64_partials, sum_u64_pair, u64_pair_to_int
from ..parallel.mesh import DeviceSet
from ..parallel.streaming import round_geometry, stream_rounds
from ..timer import Timers, timed


def _f64_total(parts) -> float:
    return float(DeviceSet.gather(parts).astype(np.float64).sum())


def _u64_total(pairs) -> int:
    """The exact sum of (lo, hi) pairs, one a device, read back together."""
    lo, hi = (DeviceSet.gather(tuple(p[i].reshape(1) for p in pairs)) for i in (0, 1))
    return sum(u64_pair_to_int(a, b) for a, b in zip(lo, hi))


class SumGpu:
    """Integer columns use the exact uint64 sum (the sum kernel on CUDA);
    float columns use the Double variant (device f32 block partials + host
    f64 combine), the analog of the reference's AggrNative<UInt64Array> /
    <DoubleArray> pair (host/aggr/aggr_native.cc:95-96)."""

    def __init__(self, ds: DeviceSet, table: Table, column: str = "a"):
        self.ds, self.table, self.column = ds, table, column
        self.timers = Timers()

    def Prepare(self):
        return self

    def Run(self) -> int | float:
        d = self.ds.nr_devices
        b = len(self.table)
        cols = [to_numpy(bt[self.column]) for bt in self.table]
        is_float = np.issubdtype(cols[0].dtype, np.floating)
        even = b % d == 0 and len({len(c) for c in cols}) == 1

        if not even:  # ragged batches (e.g. post-filter): single-array path
            with timed(self.timers, "copy-to-device"):
                dev = self.ds.scatter(np.concatenate(cols))
            with timed(self.timers, "device-work"):
                if is_float:
                    return _f64_total(sum_f64_partials(dev))
                return u64_pair_to_int(*sum_u64_pair(dev))

        # Streaming rounds (aggr_dpu.cc:55-77 round loop): per-round device
        # partials, host-side exact total.
        rpr, n_rounds = round_geometry(b, d, len(cols[0]))
        per_round = d * rpr

        def stage(r):
            return native.parallel_stack(cols[r * per_round : (r + 1) * per_round]).reshape(-1)

        if is_float:
            def dispatch(r, staged):
                return tuple(sum_f64_partials(x) for x in self.ds.split(staged))

            collect = lambda r, h: _f64_total(h)  # noqa: E731
            parts = stream_rounds(n_rounds, stage, dispatch, collect, timers=self.timers)
            return float(np.sum(parts))

        def dispatch(r, staged):
            return [sum_u64_pair(x) for x in self.ds.split(staged)]

        collect = lambda r, h: _u64_total(h)  # noqa: E731
        parts = stream_rounds(n_rounds, stage, dispatch, collect, timers=self.timers)
        return int(sum(parts))

    def Timers(self):
        return self.timers


class SumNative:
    def __init__(self, table: Table, column: str = "a"):
        self.table, self.column = table, column
        self.timers = Timers()

    def Prepare(self):
        import pyarrow as pa

        self._chunked = pa.chunked_array(
            [pa.array(to_numpy(b[self.column])) for b in self.table]
        )
        return self

    def Run(self) -> int | float:
        import pyarrow.compute as pc

        with timed(self.timers, "native-work"):
            out = pc.sum(self._chunked).as_py()
            # UInt64 for integer inputs, Double for float inputs: the two
            # reference instantiations (aggr_native.cc:95-96).
            return float(out) if isinstance(out, float) else int(out)

    def Timers(self):
        return self.timers
