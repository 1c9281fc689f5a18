"""Join operators (counterpart of ``dpu_olap_tpu/operators/join_op.py``).

JoinGpu — the counterpart of JoinTpu, the reference's JoinDpu
(host/join/join_dpu.cc): an inner PK/FK join of left (fk, y...) with right
(pk, x...). This slice ports the single-device path: Prepare() detects the
workload structure on the host, Run() uploads both tables and runs, on the
device, ops/merge.join_shard_dense (sort + gather kernels) for a dense pk,
or else ops/join.join_shard_auto: the sorted-build join (sort, bitonic
merge and fill kernels) for a sorted pk with 31-bit keys, the fused co-sort
join (sort and fill kernels, or a stable sort and the fill kernel for keys
>= 2^31 - 1) otherwise. More than one device raises NotImplementedError:
the shuffle join is ROADMAP §1 item 10.

JoinNative — pyarrow hash join (host/join/join_native.cc:31-40 oracle).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..columnar import Batch, Table, to_numpy
from ..metrics import device_log, log
from ..parallel.mesh import DeviceSet
from ..timer import Timers, timed

# Wide / float payload columns ride the 32-bit join path as u32 bit-pattern
# planes (the reference bridge moves any fixed-width column wholesale,
# host/dpuext/arrow_utils.cc:41-45). Payloads are only moved, never compared,
# so raw bit patterns are exact: an 8-byte column (u64/i64/f64) splits into
# little-endian lo/hi u32 planes, an f32 column rides as one reinterpreted
# u32 plane, and all recombine by `view` on output. NUL-prefixed suffixes
# cannot collide with user column names.
_LO = "\x00u64lo"
_HI = "\x00u64hi"
_F32 = "\x00f32"


def _split_u64_table(table: Table, key: str):
    """Rewrite wide/float payload columns into u32 bit-pattern planes.
    Returns (table, {orig_name: dtype}); no-op when nothing needs planes."""
    wide: Dict[str, np.dtype] = {}
    for b in table:
        for n in b.names:
            dt = to_numpy(b[n]).dtype
            if (dt.kind in "iuf" and dt.itemsize == 8) or (
                dt.kind == "f" and dt.itemsize == 4
            ):
                if n == key:
                    raise TypeError(
                        f"join key {n!r} must be a 32-bit integer column, got {dt}"
                    )
                wide[n] = dt
        break
    if not wide:
        return table, wide
    out = []
    for b in table:
        cols = {}
        for n in b.names:
            a = to_numpy(b[n])
            if n in wide and a.dtype.itemsize == 8:
                v = np.ascontiguousarray(a).view(np.uint32).reshape(-1, 2)
                cols[n + _LO] = np.ascontiguousarray(v[:, 0])
                cols[n + _HI] = np.ascontiguousarray(v[:, 1])
            elif n in wide:  # float32
                cols[n + _F32] = np.ascontiguousarray(a).view(np.uint32)
            else:
                cols[n] = a
        out.append(Batch.from_numpy(cols))
    return Table(out), wide


def _recombine_u64(cols: Dict[str, np.ndarray], wide) -> Dict[str, np.ndarray]:
    if not wide:
        return cols
    out: Dict[str, np.ndarray] = {}
    for n, a in cols.items():
        if n.endswith(_HI):
            continue
        if n.endswith(_LO):
            orig = n[: -len(_LO)]
            lo = a.astype(np.uint64)
            hi = cols[orig + _HI].astype(np.uint64)
            # view, not astype: bit-exact for i64 high-bit values and f64
            out[orig] = ((hi << np.uint64(32)) | lo).view(wide[orig])
        elif n.endswith(_F32):
            orig = n[: -len(_F32)]
            out[orig] = np.ascontiguousarray(a).view(wide[orig])
        else:
            out[n] = a
    return out


def _host_u32(col) -> np.ndarray:
    """A 32-bit-or-narrower column as host uint32 (the JAX path's
    ``astype(uint32)``: same bits for 4-byte ints, widened otherwise)."""
    return to_numpy(col).astype(np.uint32, copy=False)


class JoinGpu:
    """Inner PK/FK join: left (fk, y...) x right (pk, x...) -> left cols + x."""

    def __init__(
        self,
        ds: DeviceSet,
        left: Table,
        right: Table,
        fk: str = "fk",
        pk: str = "pk",
    ):
        self.ds, self.left, self.right = ds, left, right
        self.fk, self.pk = fk, pk
        self.timers = Timers()

    def Prepare(self):
        assert len(self.left) == len(self.right)
        # wide/float payload columns split into u32 bit-pattern planes here
        # and recombine in Run()
        self.left, self._l_u64 = _split_u64_table(self.left, self.fk)
        self.right, self._r_u64 = _split_u64_table(self.right, self.pk)
        self.left_cols = [c for c in self.left.names if c != self.fk]
        self.right_cols = [c for c in self.right.names if c != self.pk]
        # Workload-structure detection on the host, as JoinTpu.Prepare
        # (join_op.py:134-179): keys31 and pk_sorted select the fallback
        # joins; pk_dense (pk[i] = pk[0] + i across the concat) selects the
        # positional-gather join — always true for the reference's
        # sequential pk (generator.cc:59-71).
        lim = np.uint32(0x7FFFFFFF)
        # initial=0 keeps zero-row batches from raising on the reduction
        self.keys31 = all(
            np.max(to_numpy(b[self.fk]), initial=0) < lim for b in self.left
        ) and all(
            np.max(to_numpy(b[self.pk]), initial=0) < lim for b in self.right
        )
        pk_cols = [c for c in (to_numpy(b[self.pk]) for b in self.right) if c.size]
        self.pk_sorted = all(
            np.all(c[1:] >= c[:-1]) for c in pk_cols
        ) and all(
            pk_cols[i][-1] <= pk_cols[i + 1][0] for i in range(len(pk_cols) - 1)
        )
        self.pk_dense = (
            self.pk_sorted
            and bool(pk_cols)
            and all(np.all(np.diff(c.astype(np.int64)) == 1) for c in pk_cols)
            and all(
                int(pk_cols[i + 1][0]) - int(pk_cols[i][-1]) == 1
                for i in range(len(pk_cols) - 1)
            )
        )
        return self

    # ---- single-device direct path ----------------------------------------

    def _run_single(self) -> Dict[str, np.ndarray]:
        """One device: the dense-pk join where it applies, else
        join_shard_auto with the host-detected flags."""
        from ..ops.join import join_shard_auto
        from ..ops.merge import join_dense_eligible, join_shard_dense

        dense = self.pk_dense and join_dense_eligible(
            self.left.num_rows, self.right.num_rows
        )
        with timed(self.timers, "host-prep"):
            lf = self.left.concat()
            rt = self.right.concat()
            host = [_host_u32(lf[c]) for c in (self.fk, *self.left_cols)]
            host += [_host_u32(rt[c]) for c in (self.pk, *self.right_cols)]
        log(
            f"join {'dense' if dense else 'auto'} (keys31={self.keys31}, "
            f"pk_sorted={self.pk_sorted}): {lf.num_rows} x {rt.num_rows} rows "
            f"on {self.ds.device}"
        )
        with timed(self.timers, "h2d"):
            cols = [self.ds.scatter(a) for a in host]
        n_l = 1 + len(self.left_cols)
        args = (cols[0], tuple(cols[1:n_l]), cols[n_l], tuple(cols[n_l + 1:]))
        with timed(self.timers, "join-total"):
            if dense:
                fk, lcols, rcols, matched, ovf = join_shard_dense(*args)
                if int(ovf.item()) != 0:  # the per-thread gather cannot overflow
                    raise RuntimeError("join_shard_dense reported a gather overflow")
            else:
                fk, lcols, rcols, matched = join_shard_auto(
                    *args, keys31=self.keys31, pk_sorted=self.pk_sorted
                )
            m = DeviceSet.gather(matched)
        device_log("join matched rows", [int(m.sum())])
        with timed(self.timers, "gather-result"):
            out = {self.fk: DeviceSet.gather(fk)[m]}
            for name, col in zip(self.left_cols, lcols):
                out[name] = DeviceSet.gather(col)[m]
            for name, col in zip(self.right_cols, rcols):
                out[name] = DeviceSet.gather(col)[m]
        return out

    # ---- multi-device paths (not ported yet) ------------------------------

    def _run_ici(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError(
            "the single-round shuffle join is not ported yet (ROADMAP §1 item 10)"
        )

    def _run_partitioned(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError(
            "the host-staged partitioned join is not ported yet (ROADMAP §1 item 10)"
        )

    def _run_any(self) -> Dict[str, np.ndarray]:
        d = self.ds.nr_devices
        if d == 1:
            return self._run_single()
        if self.left.num_rows % d == 0 and self.right.num_rows % d == 0:
            return self._run_ici()
        return self._run_partitioned()

    def Run(self) -> Dict[str, np.ndarray]:
        out = self._run_any()
        return _recombine_u64(out, {**self._l_u64, **self._r_u64})

    def Timers(self):
        return self.timers


class JoinNative:
    """pyarrow inner hash-join oracle.

    partitioned=True mirrors the reference's partitioned native mode
    (host/join/join_native.cc:94-111): one join per aligned (left, right)
    batch pair, results concatenated. Correct under the generator's contract
    that every fk batch is range-bounded to its matching pk batch; the
    unpartitioned mode is the general oracle."""

    def __init__(
        self,
        left: Table,
        right: Table,
        fk: str = "fk",
        pk: str = "pk",
        partitioned: bool = False,
    ):
        self.left, self.right = left, right
        self.fk, self.pk = fk, pk
        self.partitioned = partitioned
        self.timers = Timers()

    def Prepare(self):
        import pyarrow as pa

        if self.partitioned:
            assert len(self.left) == len(self.right)
            self._pairs = [
                (
                    pa.Table.from_batches([l.to_arrow()]),
                    pa.Table.from_batches([r.to_arrow()]),
                )
                for l, r in zip(self.left, self.right)
            ]
        else:
            self._left = pa.Table.from_batches([b.to_arrow() for b in self.left])
            self._right = pa.Table.from_batches(
                [b.to_arrow() for b in self.right]
            )
        return self

    def Run(self):
        import pyarrow as pa

        with timed(self.timers, "native-work"):
            if self.partitioned:
                tables = [
                    l.join(r, keys=self.fk, right_keys=self.pk, join_type="inner")
                    for l, r in self._pairs
                ]
                return pa.concat_tables(tables)
            return self._left.join(
                self._right, keys=self.fk, right_keys=self.pk, join_type="inner"
            )

    def Timers(self):
        return self.timers
