"""Join operators (counterpart of ``dpu_olap_tpu/operators/join_op.py``).

JoinGpu — the counterpart of JoinTpu, the reference's JoinDpu
(host/join/join_dpu.cc): an inner PK/FK join of left (fk, y...) with right
(pk, x...). Prepare() detects the workload structure on the host; Run()
routes as JoinTpu does (join_op.py:402-423):
  * one round on one device (``_run_single``, the default ``impl`` and at
    most SINGLE_ROUND_ROWS rows a side): ops/merge.join_shard_dense (sort +
    gather kernels) for a dense pk, else ops/join.join_shard_auto — the
    sorted-build join (sort, bitonic merge and fill kernels) for a sorted pk
    with 31-bit keys, the fused co-sort join (sort and fill kernels, or a
    stable sort and the fill kernel) otherwise;
  * the shuffle join (``_run_ici``, parallel/dist_join.py) for another
    ``impl`` or a larger table up to MAX_RESIDENT_ROWS: both sides
    radix-partitioned (partition kernel) into ``rounds`` resident partition
    pairs, joined one round after another — the reference JoinDpu's Phase A
    and Phase B on one device; with FLAGS.join_timers it also sets
    ``phase_ms`` (parallel/dist_join.dist_join_phase_ms);
  * the host-staged partitioned join (``_run_partitioned``) beyond that:
    the Partitioner splits both tables into one hash partition per batch on
    the host, and each partition pair is joined on the device.
Over a DeviceSet of several devices the join never takes ``_run_single``:
the shuffle join splits both sides over the devices and exchanges their
fragments (parallel/dist_join.dist_join_spmd), and the partitioned join
joins rounds of d partition pairs, one pair a device; each round's flags
and masks come back in one readback.

JoinNative — pyarrow hash join (host/join/join_native.cc:31-40 oracle).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..columnar import Batch, Table, to_numpy
from ..config import FLAGS
from ..metrics import device_log, log
from ..ops.hashtable import EMPTY
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
        impl: str = "cosort",
    ):
        self.ds, self.left, self.right = ds, left, right
        self.fk, self.pk = fk, pk
        self.impl = impl
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
            lf = self._host_columns(self.left, self.fk, self.left_cols)
            rt = self._host_columns(self.right, self.pk, self.right_cols)
        log(
            f"join {'dense' if dense else 'auto'} (keys31={self.keys31}, "
            f"pk_sorted={self.pk_sorted}): {self.left.num_rows} x {self.right.num_rows} "
            f"rows on {self.ds.device}"
        )
        with timed(self.timers, "h2d"):
            lf = {c: self.ds.scatter(a) for c, a in lf.items()}
            rt = {c: self.ds.scatter(a) for c, a in rt.items()}
        args = (lf[self.fk], tuple(lf[c] for c in self.left_cols),
                rt[self.pk], tuple(rt[c] for c in self.right_cols))
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
            return self._gather_result(m, fk, lcols, rcols)

    def _host_columns(self, table: Table, key: str, cols) -> Dict[str, np.ndarray]:
        """The key and payload columns of a table, concatenated, as host
        uint32."""
        b = table.concat()
        return {c: _host_u32(b[c]) for c in (key, *cols)}

    def _gather_result(self, m: np.ndarray, fk, lcols, rcols) -> Dict[str, np.ndarray]:
        """The matched rows of a padded device result, on the host (m: the
        matched mask, already on the host)."""
        out = {self.fk: DeviceSet.gather(fk)[m]}
        for name, col in zip(self.left_cols, lcols):
            out[name] = DeviceSet.gather(col)[m]
        for name, col in zip(self.right_cols, rcols):
            out[name] = DeviceSet.gather(col)[m]
        return out

    # ---- shuffle join: resident partition rounds -------------------------

    def _run_ici(self, rounds: int | None = None) -> Dict[str, np.ndarray]:
        from ..parallel.dist_join import dist_join_retry
        from ..parallel.shuffle import default_cell_size

        n_dev = self.ds.nr_devices
        # one device: whole columns; several: one shard a device
        place = self.ds.scatter if n_dev == 1 else self.ds.split
        if rounds is None:
            rounds = self._ici_rounds()
        with timed(self.timers, "host-prep"):
            lf = self._host_columns(self.left, self.fk, self.left_cols)
            rt = self._host_columns(self.right, self.pk, self.right_cols)
        slack = FLAGS.shuffle_slack
        cell_l = default_cell_size(self.left.num_rows // n_dev, n_dev * rounds, slack)
        cell_r = default_cell_size(self.right.num_rows // n_dev, n_dev * rounds, slack)
        log(f"join shuffle impl={self.impl} rounds={rounds}: {self.left.num_rows} x "
            f"{self.right.num_rows} rows over {n_dev} devices, cells {cell_l} / {cell_r}")
        with timed(self.timers, "h2d"):
            lf = {c: place(a) for c, a in lf.items()}
            rt = {c: place(a) for c, a in rt.items()}
        with timed(self.timers, "join-total"):
            # skew handling: on fragment overflow the cells double and the
            # join runs again (the reference instead throws, partition.cc:19-26)
            (fk, lcols, rcols, matched, _), (cell_l, cell_r) = dist_join_retry(
                self.ds,
                lf[self.fk], tuple(lf[c] for c in self.left_cols),
                rt[self.pk], tuple(rt[c] for c in self.right_cols),
                impl=self.impl, cell_left=cell_l, cell_right=cell_r,
                keys31=self.keys31, rounds=rounds,
            )
            m = DeviceSet.gather(matched)
        device_log("join matched rows", m.reshape(n_dev, -1).sum(1))
        with timed(self.timers, "gather-result"):
            out = self._gather_result(m, fk, lcols, rcols)
        if FLAGS.join_timers:
            # per-phase attribution (ACTIVATE_JOIN_TIMERS, join_dpu.cc:27-49):
            # chained prefix probes, extra device work, so opt-in as the
            # reference's diagnostics build; only this route sets phase_ms
            from ..parallel.dist_join import dist_join_phase_ms

            self.phase_ms = dist_join_phase_ms(
                self.ds, lf[self.fk], rt[self.pk], len(self.left_cols), len(self.right_cols),
                cell_left=cell_l, cell_right=cell_r, impl=self.impl, keys31=self.keys31,
                rounds=rounds,
            )
            log(f"join phases: {self.phase_ms}")
        return out

    # ---- host-staged partitioned path ------------------------------------

    def _run_partitioned(self) -> Dict[str, np.ndarray]:
        from ..ops.join import join_shard, join_shard_fused
        from ..parallel.partitioner import Partitioner

        d = self.ds.nr_devices
        nparts = len(self.left)  # one partition per input batch pair
        with timed(self.timers, "partition"):
            parter = Partitioner(self.ds, nparts, timers=self.timers)
            left_parts = parter.partition_table(self.left, self.fk, self.left_cols)
            right_parts = parter.partition_table(self.right, self.pk, self.right_cols)

        def padded(cols, key, m, dev):
            """Partition columns padded to m rows (EMPTY keys, 0 payloads)
            on dev, with the valid mask."""
            n = len(cols[key])
            out = {}
            for c, a in cols.items():
                buf = np.full(m, EMPTY if c == key else 0, dtype=np.uint32)
                buf[:n] = a
                out[c] = torch.from_numpy(buf).to(dev)
            return out, torch.from_numpy(np.arange(m) < n).to(dev)

        def lane_max(parts, key):
            return max(128, -(-max(len(x[key]) for x in parts) // 128) * 128)

        # rounds of d partition pairs, one pair a device, each round padded
        # to its lane-aligned maxima as the JAX package pads them
        chunks: List[Dict[str, np.ndarray]] = []
        for r, r0 in enumerate(range(0, nparts, d)):
            lp, rp = left_parts[r0:r0 + d], right_parts[r0:r0 + d]
            ml, mr = lane_max(lp, self.fk), lane_max(rp, self.pk)
            with timed(self.timers, "build-probe-take", r):
                res = []
                for lpart, rpart, dev in zip(lp, rp, self.ds.devices):
                    lcols, lvalid = padded(lpart, self.fk, ml, dev)
                    rcols, rvalid = padded(rpart, self.pk, mr, dev)
                    args = (
                        lcols[self.fk], tuple(lcols[c] for c in self.left_cols),
                        rcols[self.pk], tuple(rcols[c] for c in self.right_cols),
                    )
                    kw = dict(left_valid=lvalid, right_valid=rvalid)
                    if self.impl == "cosort":
                        res.append(join_shard_fused(*args, keys31=self.keys31, **kw))
                    else:
                        res.append(join_shard(*args, impl=self.impl, **kw))
            with timed(self.timers, "gather-result", r):
                fk, lres, rres, matched = zip(*res)
                chunks.append(self._gather_result(DeviceSet.gather(matched), fk,
                                                  tuple(zip(*lres)), tuple(zip(*rres))))
        names = [self.fk, *self.left_cols, *self.right_cols]
        return {n: np.concatenate([c[n] for c in chunks]) for n in names}

    # Per-round working-set budget of the fused join (JoinTpu's, about ten
    # uint32 temporaries a row): above it a one-device join runs in rounds.
    SINGLE_ROUND_ROWS = 64 << 20
    # Device-resident ceiling: inputs and shuffle cells stay on the device
    # while the rounds join them; beyond it the host-staged Partitioner
    # streams out-of-core rounds (the reference's virtual-DPU outer loop,
    # join_dpu.cc:191,254).
    MAX_RESIDENT_ROWS = 256 << 20

    def _ici_rounds(self) -> int:
        # SINGLE_ROUND_ROWS is a per-device budget: each round joins
        # rows / (d * rounds) rows per device
        rows = max(self.left.num_rows, self.right.num_rows)
        per_dev = -(-rows // self.ds.nr_devices)
        return max(1, -(-per_dev // self.SINGLE_ROUND_ROWS))

    def _run_any(self) -> Dict[str, np.ndarray]:
        d = self.ds.nr_devices
        fits = (
            self.left.num_rows % d == 0
            and self.right.num_rows % d == 0
            and max(self.left.num_rows, self.right.num_rows) <= self.MAX_RESIDENT_ROWS
        )
        # join_shard_auto ignores impl, so the single-round path serves only
        # the default cosort impl; any other impl runs through the shuffle
        # join's join_shard(impl=...) even on one device, as do working sets
        # that need several resident rounds
        if (
            fits
            and d == 1
            and self.impl == "cosort"
            and max(self.left.num_rows, self.right.num_rows) <= self.SINGLE_ROUND_ROWS
        ):
            return self._run_single()
        if fits:
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
