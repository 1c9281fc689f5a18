"""Declarative query plans: the Arrow ExecPlan analog on the GPU
(counterpart of ``dpu_olap_tpu/plan.py``).

The reference's native baselines express each benchmark as an Arrow ExecPlan
(source -> filter -> sink, filter_native.cc:36-72; source -> aggregate ->
sink, aggr_native.cc:39-92; hashjoin node, join_native.cc:31-40). This module
gives the port the same composable surface: build a small plan tree, execute
it against a DeviceSet.

Nodes hand Tables to each other; a node's output is host numpy where it went
through a materializing operator (JoinGpu, SumGpu, PartitionGpu) and torch
tensors on the device where it came from the device (Filter, TakeNode, the
device-resident join), and the next node keeps device columns on the device.
Columns are uint32 (the reference's type universe); the join's payloads and
the sum also take 8-byte and float columns, as in the JAX package.

The plan runs eagerly, as the rest of the port does: where the JAX package
jit-compiles a chain (the fused filter join, the masked chunk sum), a plain
function runs the same steps, and the kernels it reaches launch one by one.
On a DeviceSet of several devices, as on the JAX package's mesh, HashJoin
skips its fused and device-resident tiers for JoinGpu's shuffle or
partitioned join over every device, Repartition takes PartitionGpu's
engines over every device, and the other nodes run on the set's first
device, as the JAX package's run on its default device.

Example (the BM_FilterDpu query):
    plan = Filter(Source(table), "a")
    out = plan.execute(ds)          # Table of passing rows, on the device
Example (the BM_JoinDpu query):
    plan = HashJoin(Source(left), Source(right), fk="fk", pk="pk")
    out = plan.execute(ds)
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .columnar import Batch, Table, to_numpy
from .metrics import count, trace
from .parallel.mesh import DeviceSet


def _dev(ds: DeviceSet, col) -> torch.Tensor:
    """A column as a tensor on ds's device (a host column is copied there)."""
    if isinstance(col, torch.Tensor):
        return col.to(ds.device)
    return ds.scatter(np.asarray(col))


def _np_dtype(col) -> np.dtype:
    """A column's dtype as numpy's, without copying a device column."""
    if isinstance(col, torch.Tensor):
        return col[:0].cpu().numpy().dtype
    return np.asarray(col).dtype


def _is_u32(col) -> bool:
    return _np_dtype(col) == np.uint32


def _readback(site: str, scalar) -> bool:
    """A device scalar's truth on the host: one readback, counted as
    ``readback.plan.<site>``."""
    count(f"readback.plan.{site}")
    return bool(scalar)


class Node:
    def execute(self, ds: DeviceSet) -> Table:
        raise NotImplementedError

    # result cache so diamond-shaped plans execute each node once per
    # DeviceSet. Keyed on the DeviceSet OBJECT (WeakKeyDictionary): an
    # id()-keyed dict would serve a stale Table when a collected DeviceSet's
    # id is recycled by a new one. A miss runs in the span
    # dpu_olap.plan.<node class>.
    def _run(self, ds) -> Table:
        cache = self.__dict__.setdefault("_cached", weakref.WeakKeyDictionary())
        if ds not in cache:
            with trace(f"dpu_olap.plan.{type(self).__name__}"):
                cache[ds] = self.execute(ds)
        return cache[ds]


@dataclasses.dataclass
class Source(Node):
    """Scan of an in-memory Table (the source ExecNode)."""

    table: Table

    def execute(self, ds: DeviceSet) -> Table:
        return self.table


@dataclasses.dataclass
class Filter(Node):
    """Predicate filter on one column, keeping whole rows, on the device.

    With the default predicate this is the BM_Filter query (v < 2^30): the
    filter kernel (csrc/filter.cu) compacts the column and, where the batch
    has other columns, gives the kept rows' numbers, through which every
    other column is gathered (ops/filter.filter_with_indices + ops/take.take,
    the reference's selection-indices pattern). A predicate is a function of
    a tensor that returns its mask."""

    input: Node
    column: str
    predicate: Optional[Callable] = None

    def execute(self, ds: DeviceSet) -> Table:
        from .ops.filter import default_predicate, filter_compact, filter_with_indices
        from .ops.take import take

        pred = self.predicate or default_predicate
        out = []
        for batch in self.input._run(ds):
            col = _dev(ds, batch[self.column])
            others = [n for n in batch.names if n != self.column]
            if not others:
                vals, kept = filter_compact(col, predicate=pred)
                out.append(Batch({self.column: vals[: int(kept)]}))
                continue
            vals, idxs, kept = filter_with_indices(col, predicate=pred)
            c = int(kept)
            cols = {self.column: vals[:c]}
            for n in others:
                cols[n] = take(_dev(ds, batch[n]), idxs[:c])
            out.append(Batch(cols))
        return Table(out)


@dataclasses.dataclass
class Project(Node):
    """Column selection (the project ExecNode)."""

    input: Node
    columns: Sequence[str]

    def execute(self, ds: DeviceSet) -> Table:
        return Table([b.select(list(self.columns)) for b in self.input._run(ds)])


def _compact_device(matched: torch.Tensor, cols: dict) -> dict:
    """Compact padded join rows to matched rows without leaving the device:
    the filter kernel turns the mask into a selection vector, each column
    gathers through it, and only the row count (one scalar) crosses to the
    host (reference: results stay on the DPU until the final gather,
    host/dpuext/dpuext.hpp:859-875)."""
    from .ops.filter import filter_with_indices
    from .ops.take import take

    with trace("dpu_olap.plan.compact"):
        # encode the mask so the default predicate (v < 2^30) selects
        # matched rows: the filter kernel serves only that predicate
        plane = torch.where(matched, 0, -1).to(torch.int32).view(torch.uint32)
        _, idxs, kept = filter_with_indices(plane)
        count("readback.plan.compact")
        sel = idxs[: int(kept)]  # the one host readback
        return {n: take(col, sel) for n, col in cols.items()}


def _recombine(tags, outs, m: np.ndarray, wide: dict) -> dict:
    """Host columns of the matched rows m from the join's output planes:
    8-byte columns from their lo/hi u32 planes, f32 from its reinterpreted
    plane, by view (bit-exact for i64 high-bit values, NaN and inf)."""
    cols, halves = {}, {}
    for (n, part), c in zip(tags, outs):
        a = to_numpy(c)[m]
        if part is None:
            cols[n] = a
        elif part == "f32":
            cols[n] = np.ascontiguousarray(a).view(wide[n])
        else:
            halves.setdefault(n, {})[part] = a
    for n, h in halves.items():
        lo = h["lo"].astype(np.uint64)
        hi = h["hi"].astype(np.uint64)
        cols[n] = ((hi << np.uint64(32)) | lo).view(wide[n])
    return cols


@dataclasses.dataclass
class HashJoin(Node):
    """PK/FK inner join (the hashjoin ExecNode / BM_JoinDpu query). Three
    tiers, in the order tried:
      * fused: both sides Source -> (Filter|Project)* with a transform on
        at least one side, one round: the filters become join_shard_fused's
        validity masks (no intermediate Table, no compaction pass);
      * device-resident: a side already on the device (an upstream node's
        output) joins there (the sorted-build or co-sort join's steps)
        and its matched rows stay there;
      * JoinGpu with its routing (dense, sorted-build, fused, shuffle or
        partitioned join) on host tables.
    On several devices only the last is taken, as in the JAX plan
    (plan.py:149, 165-168)."""

    left: Node
    right: Node
    fk: str = "fk"
    pk: str = "pk"
    impl: str = "cosort"

    def execute(self, ds: DeviceSet) -> Table:
        from .operators.join_op import JoinGpu

        one = ds.nr_devices == 1
        if one and self.impl == "cosort":
            lc = _streamable_chain(self.left)
            rc = _streamable_chain(self.right)
            if lc is not None and rc is not None:
                out = self._fused_filter_join(ds, lc, rc)
                if out is not None:
                    return out

        lt = self.left._run(ds)
        rt = self.right._run(ds)

        # device-resident tier: an upstream node handed this join device
        # columns (e.g. a materialized Filter output); join them in place and
        # return device columns; only scalar structure probes and the
        # matched count cross to the host
        if one and self.impl == "cosort" and (lt.is_device or rt.is_device):
            out = self._device_join(ds, lt, rt)
            if out is not None:
                return out

        op = JoinGpu(ds, lt, rt, fk=self.fk, pk=self.pk, impl=self.impl).Prepare()
        return Table([Batch.from_numpy(op.Run())])

    def _device_join(self, ds: DeviceSet, lt: Table, rt: Table):
        """Join uint32 tables on the device into a device-resident compacted
        Table. Structure detection (keys31, pk_sorted) runs as device
        reductions with scalar readbacks, not the operator's host scans,
        which would copy the very intermediates this tier keeps resident.
        With keys31 join_shard_auto's last kernel writes only the matched
        rows (merge.fill_match_compact); the generic join's padded output
        is compacted by _compact_device. Either way the row count is the one
        readback after the join."""
        from .ops.join import join_shard_auto

        with trace("dpu_olap.plan.dtypes"):
            for tab in (lt, rt):
                for b in tab:
                    if not all(_is_u32(b[n]) for n in b.names):
                        return None  # wide/float planes: operator tier

        def cat(tab, name):
            cols = [_dev(ds, b[name]) for b in tab]
            return cols[0] if len(cols) == 1 else torch.cat(cols)

        with trace("dpu_olap.plan.concat"):
            lf = cat(lt, self.fk)
            rk = cat(rt, self.pk)
            lnames = [n for n in lt.names if n != self.fk]
            rnames = [n for n in rt.names if n != self.pk]
            lps = tuple(cat(lt, n) for n in lnames)
            rps = tuple(cat(rt, n) for n in rnames)
        if lf.shape[0] == 0 or rk.shape[0] == 0:
            return None

        lim = 0x7FFFFFFF
        with trace("dpu_olap.plan.structure"):
            lf64, rk64 = lf.to(torch.int64), rk.to(torch.int64)
            keys31 = _readback("keys31", lf64.max() < lim) and _readback("keys31", rk64.max() < lim)
            pk_sorted = (_readback("pk_sorted", (rk64[1:] >= rk64[:-1]).all())
                         if rk.shape[0] > 1 else True)
        fk, lcols, rcols, last = join_shard_auto(
            lf, lps, rk, rps, keys31=keys31, pk_sorted=pk_sorted,
            capacity=lf.shape[0] if keys31 else None,
        )
        cols = {self.fk: fk}
        cols.update(dict(zip(lnames, lcols)))
        cols.update(dict(zip(rnames, rcols)))
        if not keys31:
            return Table([Batch(_compact_device(last, cols))])
        count("readback.plan.compact")
        c = int(last)  # the matched rows, at most the probe rows
        # views of the first c rows; a copy where fewer than half the
        # capacity's rows are kept, so that a selective join's Table does
        # not hold the probe side's size alive downstream
        rows = (lambda p: p[:c].clone()) if 2 * c < lf.shape[0] else (lambda p: p[:c])
        return Table([Batch({name: rows(p) for name, p in cols.items()})])

    @staticmethod
    def _side_plan(table: Table, transforms, key: str):
        """Resolve a side's (payload column names, [(col, predicate)]) after
        applying the chain's Projects/Filters; raises like the materializing
        tier on projected-away columns."""
        from .ops.filter import default_predicate

        avail = list(table.names)
        preds = []
        for t in transforms:
            if isinstance(t, Filter):
                if t.column not in avail:
                    raise KeyError(f"filter column {t.column!r} projected away")
                preds.append((t.column, t.predicate or default_predicate))
            else:
                if key not in t.columns:
                    raise KeyError(f"join key {key!r} projected away")
                avail = [c for c in avail if c in set(t.columns)]
        return [c for c in avail if c != key], preds

    def _fused_filter_join(self, ds: DeviceSet, lc, rc):
        from .operators.join_op import JoinGpu
        from .ops.join import join_shard_fused

        ltab, ltrans = lc
        rtab, rtrans = rc
        # The fused tier exists to absorb Filter/Project transforms into the
        # join; a bare Source->Source join gains nothing from it and would
        # lose JoinGpu's routing (the dense and sorted-build joins) and its
        # working-set budgets (the shuffle and partitioned joins), so it is
        # taken only with transforms present and both sides in one round.
        if not (ltrans or rtrans):
            return None
        if max(ltab.num_rows, rtab.num_rows) > JoinGpu.SINGLE_ROUND_ROWS:
            return None
        lnames, lpreds = self._side_plan(ltab, ltrans, self.fk)
        rnames, rpreds = self._side_plan(rtab, rtrans, self.pk)
        lf = ltab.concat()
        rt = rtab.concat()
        # keys and predicate columns must be 32-bit integers (predicates
        # evaluate on the raw plane); wide/float payload columns ride as u32
        # bit-pattern planes recombined on the host: 8-byte (u64/i64/f64)
        # as lo/hi pairs, f32 as one reinterpreted plane
        for c in (lf[self.fk], rt[self.pk],
                  *[lf[n] for n, _ in lpreds], *[rt[n] for n, _ in rpreds]):
            dt = _np_dtype(c)
            if dt.kind not in "iu" or dt.itemsize != 4:
                return None
        wide: dict = {}
        for tab, names in ((lf, lnames), (rt, rnames)):
            for n in names:
                dt = _np_dtype(tab[n])
                if (dt.itemsize == 8 and dt.kind in "iuf") or (dt.kind == "f" and dt.itemsize == 4):
                    wide[n] = dt
                elif dt.kind not in "iu" or dt.itemsize != 4:
                    return None  # non-fixed-width: the materializing tier raises
        lim = 0x7FFFFFFF
        keys31 = bool(
            int(np.max(to_numpy(lf[self.fk]), initial=0)) < lim
            and int(np.max(to_numpy(rt[self.pk]), initial=0)) < lim
        )

        def planes_for(tab, names):
            arrs, tags = [], []
            for n in names:
                a = to_numpy(tab[n])
                if n in wide and a.dtype.itemsize == 8:
                    v = np.ascontiguousarray(a).view(np.uint32).reshape(-1, 2)
                    arrs += [np.ascontiguousarray(v[:, 0]), np.ascontiguousarray(v[:, 1])]
                    tags += [(n, "lo"), (n, "hi")]
                elif n in wide:  # float32: one reinterpreted u32 plane
                    arrs.append(np.ascontiguousarray(a).view(np.uint32))
                    tags.append((n, "f32"))
                else:
                    arrs.append(a)
                    tags.append((n, None))
            return tuple(_dev(ds, x) for x in arrs), tags

        def valid(tab, preds):
            mask = None
            for name, pred in preds:
                m = pred(_dev(ds, tab[name]))
                mask = m if mask is None else mask & m
            return mask

        lplanes, ltags = planes_for(lf, lnames)
        rplanes, rtags = planes_for(rt, rnames)
        fk, lout, rout, matched = join_shard_fused(
            _dev(ds, lf[self.fk]), lplanes, _dev(ds, rt[self.pk]), rplanes,
            left_valid=valid(lf, lpreds), right_valid=valid(rt, rpreds), keys31=keys31,
        )
        m = to_numpy(matched)
        cols = {self.fk: to_numpy(fk)[m]}
        cols.update(_recombine(ltags + rtags, (*lout, *rout), m, wide))
        order = [self.fk, *lnames, *rnames]
        return Table([Batch.from_numpy({n: cols[n] for n in order})])


def _masked_sum(fns: tuple, column: str, cols: dict):
    """The chunk step of a (Filter|Project)* -> Sum chain: the filters are
    validity masks over the aggregated column, then the exact uint64 sum
    (the sum kernel) as a (lo, hi) pair of device scalars."""
    from .ops.aggregate import sum_u64_pair

    valid = None
    for kind, col, pred in fns:
        if kind == "filter":
            m = pred(cols[col])
            valid = m if valid is None else valid & m
    v = cols[column]
    if valid is not None:
        v = torch.where(valid, v.view(torch.int32), 0).view(torch.uint32)
    return sum_u64_pair(v)


def _streamable_chain(node):
    """If ``node``'s input chain is Source -> (Filter|Project)* it can
    execute as a device-resident chunk stream. Returns (source_table,
    transforms source-to-sink) or None."""
    chain: list = []
    cur = node
    while True:
        if isinstance(cur, Source):
            return cur.table, list(reversed(chain))
        if isinstance(cur, (Filter, Project)) and "_cached" not in cur.__dict__:
            chain.append(cur)
            cur = cur.input
            continue
        return None


@dataclasses.dataclass
class Aggregate(Node):
    """Scalar aggregation (the aggregate ExecNode; AggrSum is the reference's
    only registered aggregator, shared/umq/kernels.h:44).

    Tiers, in the order tried, for a uint32 column:
      * streaming: the input chain is Source -> (Filter|Project)*; execute()
        never materializes an intermediate Table: each source batch streams
        through parallel/streaming.stream_rounds (staging one round ahead),
        its filters become validity masks over the column and the sum kernel
        reduces it; the (lo, hi) partials stay on the device until one
        readback at the end. The ExecPlan/AsyncGenerator analog
        (host/filter/filter_native.cc:36-72, generator.cc:73-101);
      * order-free take: TakeNode(Source, Source) -> Sum gathers through
        take_sorted_stream (sort and gather kernels, no restore sort) and
        sums in place;
      * device-resident input: per-batch exact sums in place;
      * SumGpu otherwise, and for a float column always (its Double
        variant, the reference's AggrNative<DoubleArray>,
        aggr_native.cc:95-96)."""

    input: Node
    column: str
    agg: str = "sum"

    def execute(self, ds: DeviceSet) -> Table:
        from .ops.aggregate import sum_u64_pair, u64_pair_to_int

        if self.agg != "sum":
            raise ValueError(f"unsupported aggregate {self.agg!r}")
        u32_col = self._column_is_u32()
        chain = _streamable_chain(self.input) if u32_col else None
        if chain is not None:
            result = self._stream_scalar(ds, *chain)
        elif u32_col and (result := self._take_sum_stream(ds)) is not None:
            pass
        else:
            t = self.input._run(ds)
            with trace("dpu_olap.plan.sum"):
                resident = (t.is_device and u32_col is not False
                            and all(_is_u32(b[self.column]) for b in t))
                if resident:
                    # device-resident input (an upstream node's
                    # un-materialized result): reduce in place, scalar
                    # readbacks only
                    result = sum(u64_pair_to_int(*sum_u64_pair(b[self.column])) for b in t)
                    result &= (1 << 64) - 1
            if not resident:
                from .operators.aggr_op import SumGpu

                result = SumGpu(ds, t, self.column).Prepare().Run()
        if isinstance(result, float):
            return Table([Batch.from_numpy({self.agg: np.asarray([result], np.float64)})])
        lo = np.uint32(result & 0xFFFFFFFF)
        hi = np.uint32(result >> 32)
        return Table([Batch.from_numpy(
            {f"{self.agg}_lo": np.asarray([lo]), f"{self.agg}_hi": np.asarray([hi])})])

    def _column_is_u32(self):
        """True/False when the aggregated column's dtype is visible at a
        Source below (Projects/Filters don't change dtypes); None when the
        input isn't a plain source chain (resolved after execution)."""
        cur = self.input
        while isinstance(cur, (Filter, Project)):
            cur = cur.input
        if isinstance(cur, TakeNode) and isinstance(cur.input, Source):
            cur = cur.input
        if isinstance(cur, Source) and cur.table.batches:
            b = cur.table[0]
            if self.column in b.names:
                return _is_u32(b[self.column])
        return None

    def _take_sum_stream(self, ds: DeviceSet):
        """TakeNode(Source, Source) -> Sum: a sum is order-invariant, so the
        gather runs as the order-free take_sorted_stream (the restore sort
        that query-order consumers pay is skipped) and the take result never
        reaches the host. Returns the uint64 sum, or None when the chain or
        shapes don't fit (the materializing tier then gives the same sum:
        both clip out-of-range indices)."""
        from .ops.aggregate import sum_u64_pair, u64_pair_to_int
        from .ops.take_cuda import take_sorted_stream, takeable_sorted

        node = self.input
        if not isinstance(node, TakeNode) or "_cached" in node.__dict__:
            return None
        if not (isinstance(node.input, Source) and isinstance(node.indices, Source)):
            return None
        data, idx = node.input.table, node.indices.table
        if len(data) != len(idx) or self.column not in data.names:
            return None
        for db, ib in zip(data, idx):
            if not _is_u32(db[self.column]):
                return None
            if not takeable_sorted(db.num_rows, ib[node.index_column].shape[0]):
                return None

        total = 0
        for db, ib in zip(data, idx):
            d = _dev(ds, db[self.column])
            q = _dev(ds, ib[node.index_column])
            _, val, flag = take_sorted_stream(d, q)
            if int(flag) != 0:  # the gather has no window: a flag is a bug
                raise RuntimeError("take_sorted_stream reported a gather overflow")
            total += u64_pair_to_int(*sum_u64_pair(val))
        return total & ((1 << 64) - 1)

    def _stream_scalar(self, ds: DeviceSet, table: Table, transforms) -> int:
        from .ops.filter import default_predicate
        from .parallel.streaming import stream_rounds

        # columns each chunk needs on the device: the aggregated column plus
        # every filter's predicate column (projections only narrow names)
        needed = {self.column}
        for t in transforms:
            if isinstance(t, Filter):
                needed.add(t.column)

        fns = []  # (kind, column, predicate) applied in source->sink order
        avail = None  # None = every source column (narrowed by Projects)
        for t in transforms:
            if isinstance(t, Filter):
                # as the materializing tier: a predicate column dropped by an
                # upstream Project is an error, not a read through to the
                # source
                if avail is not None and t.column not in avail:
                    raise KeyError(f"filter column {t.column!r} projected away")
                fns.append(("filter", t.column, t.predicate or default_predicate))
            else:
                if self.column not in t.columns:
                    raise KeyError(f"aggregate column {self.column!r} projected away")
                avail = set(t.columns)
        fns = tuple(fns)

        def stage(r):
            b = table[r]
            return {n: to_numpy(b[n]) for n in needed if n in b.names}

        def dispatch(r, staged):
            return _masked_sum(fns, self.column, {n: ds.scatter(a) for n, a in staged.items()})

        def collect(r, handle):
            # the (lo, hi) pair stays on the device: one stacked readback at
            # the end instead of one a round
            return handle

        parts = stream_rounds(len(table), stage, dispatch, collect)
        los = torch.stack([p[0] for p in parts]).cpu().numpy().astype(np.uint64)
        his = torch.stack([p[1] for p in parts]).cpu().numpy().astype(np.uint64)
        total = int((his << np.uint64(32)).sum(dtype=np.uint64) + los.sum())
        return total & ((1 << 64) - 1)

    def scalar(self, ds: DeviceSet) -> int | float:
        t = self._run(ds)
        b = t[0].to_numpy()
        if self.agg in b:  # float (Double) aggregate: one f64 column
            return float(b[self.agg][0])
        return (int(b[f"{self.agg}_hi"][0]) << 32) | int(b[f"{self.agg}_lo"][0])


@dataclasses.dataclass
class TakeNode(Node):
    """Gather rows by an index table (the take compute kernel), on the
    device: ops/take.take of every column of each batch."""

    input: Node
    indices: Node
    index_column: str = "i"

    def execute(self, ds: DeviceSet) -> Table:
        from .ops.take import take

        data = self.input._run(ds)
        idx = self.indices._run(ds)
        if len(data) != len(idx):
            raise ValueError("TakeNode needs one index batch per data batch")
        out = []
        for db, ib in zip(data, idx):
            sel = _dev(ds, ib[self.index_column])
            out.append(Batch({n: take(_dev(ds, db[n]), sel) for n in db.names}))
        return Table(out)


@dataclasses.dataclass
class Repartition(Node):
    """Hash repartition by a key column (the standalone partition op,
    PartitionGpu), as host partitions: one batch per non-empty partition."""

    input: Node
    key: str
    nr_partitions: int

    def execute(self, ds: DeviceSet) -> Table:
        from .operators.partition_op import PartitionGpu

        t = self.input._run(ds)
        parts = PartitionGpu(ds, t, self.key, self.nr_partitions).Prepare().Run()
        if hasattr(parts, "to_host"):  # DevicePartitions (resident engine)
            parts = parts.to_host()
        return Table([Batch.from_numpy(p) for p in parts if len(next(iter(p.values())))])
