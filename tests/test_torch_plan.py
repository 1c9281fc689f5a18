"""The port's query plan (dpu_olap_tpu_torch.plan) against the JAX package's
(dpu_olap_tpu.plan), one twin for each test of tests/test_plan.py, at one
CPU device, plus Batch.select/add_column/take/slice against the JAX Batch.

Both packages get the same bytes: the JAX package's Tables (its generator or
numpy arrays made from a seed) and the port's Tables made from them with
Table.from_reference. Tolerances: row results are held bit for bit after a
canonical sort (both joins are unstable on ties; float columns are compared
as their bit patterns), u64 sums exactly, and the float (Double) aggregate
to rtol=1e-6, as tests/test_plan.py:487 holds the JAX package to numpy (the
two packages add their f32 block partials in other orders).
"""

import gc
import weakref

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import dpu_olap_tpu.plan as jplan
from dpu_olap_tpu.columnar import Batch as JBatch
from dpu_olap_tpu.columnar import Table as JTable
from dpu_olap_tpu.generator import make_filter_batches, make_join_tables, make_take_batches
from dpu_olap_tpu.parallel.mesh import DeviceSet as JaxDeviceSet
from dpu_olap_tpu_torch import metrics
from dpu_olap_tpu_torch import plan as tplan
from dpu_olap_tpu_torch.columnar import Batch, Table, to_numpy
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

F32_RTOL = 1e-6


@pytest.fixture(scope="module")
def jds():
    return JaxDeviceSet.allocate(1)


@pytest.fixture(scope="module")
def ds():
    return DeviceSet(torch.device("cpu"))


def port(t: JTable) -> Table:
    return Table.from_reference(t)


def host_tables(**cols_by_side):
    """One-batch JAX tables from numpy columns, and the port's twins."""
    out = []
    for cols in cols_by_side.values():
        jt = JTable([JBatch.from_numpy(cols)])
        out += [jt, port(jt)]
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}")).astype(np.uint64)


def canon(t) -> tuple:
    """(names, rows after a canonical sort) of a Table of either package."""
    names = list(t.names)
    if not t.batches:
        return names, np.zeros((len(names), 0), np.uint64)
    rows = np.stack([
        np.concatenate([_bits(to_numpy(b[n])) for b in t.batches]) for n in names
    ])
    return names, rows[:, np.lexsort(rows[::-1])]


def assert_same_rows(got, want):
    gn, gr = canon(got)
    wn, wr = canon(want)
    assert gn == wn
    np.testing.assert_array_equal(gr, wr)


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert gb.names == wb.names
        for n in gb.names:
            g, w = to_numpy(gb[n]), to_numpy(wb[n])
            assert g.dtype == w.dtype, n
            np.testing.assert_array_equal(g, w)


def test_filter_plan(ds, jds):
    jt = make_filter_batches(4, 1 << 12)
    out = tplan.Filter(tplan.Source(port(jt)), "a").execute(ds)
    assert out.is_device
    assert_same_batches(out, jplan.Filter(jplan.Source(jt), "a").execute(jds))
    for got, b in zip(out, jt):
        arr = pa.array(np.asarray(b["a"]))
        expect = pc.filter(arr, pc.less(arr, pa.scalar(1 << 30, pa.uint32()))).to_numpy()
        np.testing.assert_array_equal(to_numpy(got["a"]), expect)


def test_filter_plan_multi_column(ds, jds):
    rng = np.random.default_rng(42)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    b = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    jt, t = host_tables(t={"a": a, "b": b})
    out = tplan.Filter(tplan.Source(t), "a").execute(ds)
    assert_same_batches(out, jplan.Filter(jplan.Source(jt), "a").execute(jds))
    mask = a < (1 << 30)
    np.testing.assert_array_equal(to_numpy(out[0]["b"]), b[mask])


def test_join_plan(ds, jds):
    left, right = make_join_tables(8, 1 << 10, 1 << 9)
    out = tplan.HashJoin(tplan.Source(port(left)), tplan.Source(port(right))).execute(ds)
    want = jplan.HashJoin(jplan.Source(left), jplan.Source(right)).execute(jds)
    assert out.num_rows == want.num_rows > 0
    assert_same_rows(out, want)


def test_aggregate_plan(ds, jds):
    jt = make_filter_batches(8, 1 << 12)
    got = tplan.Aggregate(tplan.Source(port(jt)), "a").scalar(ds)
    assert got == jplan.Aggregate(jplan.Source(jt), "a").scalar(jds)
    chunked = pa.chunked_array([pa.array(np.asarray(b["a"])) for b in jt])
    assert got == int(pc.sum(chunked).as_py())


def test_filter_then_aggregate_composes(ds, jds):
    jt = make_filter_batches(4, 1 << 12)
    got = tplan.Aggregate(tplan.Filter(tplan.Source(port(jt)), "a"), "a").scalar(ds)
    assert got == jplan.Aggregate(jplan.Filter(jplan.Source(jt), "a"), "a").scalar(jds)


def test_take_plan(ds, jds):
    data, idx = make_take_batches(4, 1 << 12, 1 << 9)
    out = tplan.TakeNode(tplan.Source(port(data)), tplan.Source(port(idx))).execute(ds)
    assert out.is_device
    assert_same_batches(out, jplan.TakeNode(jplan.Source(data), jplan.Source(idx)).execute(jds))


def test_project_plan(ds, jds):
    left, _ = make_join_tables(2, 256, 128)
    out = tplan.Project(tplan.Source(port(left)), ["y"]).execute(ds)
    assert out.names == ["y"]
    assert_same_batches(out, jplan.Project(jplan.Source(left), ["y"]).execute(jds))


def test_repartition_plan(ds, jds):
    jt = make_filter_batches(8, 1 << 12)
    out = tplan.Repartition(tplan.Source(port(jt)), "a", 16).execute(ds)
    want = jplan.Repartition(jplan.Source(jt), "a", 16).execute(jds)
    assert out.num_rows == jt.num_rows
    assert len(out) == len(want)
    for gb, wb in zip(out, want):  # the same partitions in the same order
        assert_same_rows(Table([gb]), JTable([wb]))


def _boom(self, ds):
    raise AssertionError("a chain node materialized a Table")


def test_streaming_filter_sum_no_materialization(ds, jds, monkeypatch):
    """Filter -> Aggregate runs as the streaming tier: Filter.execute is
    never called, and the sum is the JAX package's."""
    jt = make_filter_batches(6, 1 << 12)
    want = jplan.Aggregate(jplan.Filter(jplan.Source(jt), "a"), "a").scalar(jds)
    monkeypatch.setattr(tplan.Filter, "execute", _boom)
    got = tplan.Aggregate(tplan.Filter(tplan.Source(port(jt)), "a"), "a").scalar(ds)
    assert got == want


def test_streaming_project_filter_sum(ds, jds, monkeypatch):
    jt = make_filter_batches(4, 1 << 12)
    want = jplan.Aggregate(
        jplan.Project(jplan.Filter(jplan.Source(jt), "a"), ["a"]), "a").scalar(jds)
    monkeypatch.setattr(tplan.Filter, "execute", _boom)
    monkeypatch.setattr(tplan.Project, "execute", _boom)
    got = tplan.Aggregate(
        tplan.Project(tplan.Filter(tplan.Source(port(jt)), "a"), ["a"]), "a").scalar(ds)
    assert got == want


def test_streaming_matches_materializing(ds, jds):
    jt = make_filter_batches(4, 1 << 12)
    t = port(jt)
    streamed = tplan.Aggregate(tplan.Filter(tplan.Source(t), "a"), "a").scalar(ds)
    f = tplan.Filter(tplan.Source(t), "a")
    f._run(ds)  # populates the node cache -> the chain is not streamable
    assert tplan.Aggregate(f, "a").scalar(ds) == streamed
    assert streamed == jplan.Aggregate(jplan.Filter(jplan.Source(jt), "a"), "a").scalar(jds)


def test_streaming_projected_away_column_raises(ds, jds):
    jt = make_filter_batches(2, 1 << 10)
    with pytest.raises(KeyError):
        jplan.Aggregate(jplan.Project(jplan.Source(jt), ["a"]), "b").scalar(jds)
    with pytest.raises(KeyError):
        tplan.Aggregate(tplan.Project(tplan.Source(port(jt)), ["a"]), "b").scalar(ds)


def test_streaming_rejects_projected_filter_column(ds, jds):
    jt = make_filter_batches(num_batches=8, batch_size=1 << 10)
    with pytest.raises(KeyError):
        jplan.Aggregate(jplan.Filter(jplan.Project(jplan.Source(jt), ["b"]), "a"), "b").execute(jds)
    with pytest.raises(KeyError):
        tplan.Aggregate(
            tplan.Filter(tplan.Project(tplan.Source(port(jt)), ["b"]), "a"), "b").execute(ds)


def test_fused_filter_join_matches_materializing(ds, jds):
    left, right = make_join_tables(4, 1 << 12, 1 << 12)
    pl, pr = port(left), port(right)
    fused = tplan.HashJoin(
        tplan.Filter(tplan.Source(pl), "y"), tplan.Filter(tplan.Source(pr), "x")).execute(ds)
    f_l, f_r = tplan.Filter(tplan.Source(pl), "y"), tplan.Filter(tplan.Source(pr), "x")
    f_l._run(ds)
    f_r._run(ds)
    mat = tplan.HashJoin(f_l, f_r).execute(ds)
    want = jplan.HashJoin(
        jplan.Filter(jplan.Source(left), "y"), jplan.Filter(jplan.Source(right), "x")).execute(jds)
    assert fused.num_rows == mat.num_rows == want.num_rows > 0
    assert_same_rows(fused, want)
    assert_same_rows(mat.to_host(), want)


def test_fused_filter_join_project_narrows_columns(ds, jds):
    left, right = make_join_tables(2, 1 << 12, 1 << 12)
    out = tplan.HashJoin(
        tplan.Project(tplan.Filter(tplan.Source(port(left)), "y"), ["fk"]),
        tplan.Source(port(right))).execute(ds)
    want = jplan.HashJoin(
        jplan.Project(jplan.Filter(jplan.Source(left), "y"), ["fk"]),
        jplan.Source(right)).execute(jds)
    assert sorted(out.names) == ["fk", "x"] and out.num_rows > 0
    assert_same_rows(out, want)


def test_node_cache_not_keyed_on_recycled_id():
    # _run caches per DeviceSet OBJECT (WeakKeyDictionary): a dead
    # DeviceSet's entry goes with it, so a recycled id cannot alias it
    jt = make_filter_batches(1, 1 << 10)
    node = tplan.Filter(tplan.Source(port(jt)), "a")
    ds1 = DeviceSet(torch.device("cpu"))
    out1 = node._run(ds1)
    cache = node.__dict__["_cached"]
    assert isinstance(cache, weakref.WeakKeyDictionary)
    assert len(cache) == 1
    del ds1
    gc.collect()
    assert len(cache) == 0
    out2 = node._run(DeviceSet(torch.device("cpu")))
    assert_same_batches(out1, out2)
    assert_same_batches(out1, jplan.Filter(jplan.Source(jt), "a").execute(JaxDeviceSet.allocate(1)))


def _spy(monkeypatch, cls, name, calls, key):
    orig = getattr(cls, name)

    def spy(self, *a):
        out = orig(self, *a)
        if out is not None:
            calls[key] += 1
        return out

    monkeypatch.setattr(cls, name, spy)


def test_bare_source_join_uses_joingpu_routing(ds, jds, monkeypatch):
    # a Source->Source HashJoin goes through JoinGpu (its dense and
    # sorted-build routing and its budgets), not the fused tier; with a
    # transform present the fused tier applies and JoinGpu is not built
    from dpu_olap_tpu_torch.operators import join_op

    left, right = make_join_tables(2, 1 << 10, 1 << 10)
    pl, pr = port(left), port(right)
    calls = {"fused": 0, "joingpu": 0, "dense": 0}
    _spy(monkeypatch, tplan.HashJoin, "_fused_filter_join", calls, "fused")
    _spy(monkeypatch, join_op.JoinGpu, "_run_single", calls, "joingpu")
    orig_prepare = join_op.JoinGpu.Prepare

    def prepare(self):
        out = orig_prepare(self)
        calls["dense"] += int(self.pk_dense)
        return out

    monkeypatch.setattr(join_op.JoinGpu, "Prepare", prepare)
    bare = tplan.HashJoin(tplan.Source(pl), tplan.Source(pr)).execute(ds)
    assert calls == {"fused": 0, "joingpu": 1, "dense": 1}
    assert_same_rows(bare, jplan.HashJoin(jplan.Source(left), jplan.Source(right)).execute(jds))
    filt = tplan.HashJoin(tplan.Filter(tplan.Source(pl), "y"), tplan.Source(pr)).execute(ds)
    assert calls == {"fused": 1, "joingpu": 1, "dense": 1}
    assert_same_rows(
        filt, jplan.HashJoin(jplan.Filter(jplan.Source(left), "y"), jplan.Source(right)).execute(jds))


def test_fused_filter_join_u64_payload(ds, jds):
    rng = np.random.default_rng(3)
    n = 1 << 12
    pk = np.arange(n, dtype=np.uint32)
    x64 = rng.integers(0, 2**64, n, dtype=np.uint64)
    fk = rng.integers(0, n, n, dtype=np.uint32)
    y = rng.integers(0, 2**32, n, dtype=np.uint32)
    jl, tl, jr, tr = host_tables(l={"fk": fk, "y": y}, r={"pk": pk, "x64": x64})
    out = tplan.HashJoin(tplan.Filter(tplan.Source(tl), "y"), tplan.Source(tr)).execute(ds)
    want = jplan.HashJoin(jplan.Filter(jplan.Source(jl), "y"), jplan.Source(jr)).execute(jds)
    assert out.num_rows > 0
    assert to_numpy(out.concat()["x64"]).dtype == np.uint64
    assert_same_rows(out, want)


def test_fused_filter_join_float_payloads(ds, jds, monkeypatch):
    rng = np.random.default_rng(5)
    n = 1 << 12
    pk = np.arange(n, dtype=np.uint32)
    xf = rng.integers(0, 2**64, n, dtype=np.uint64).view(np.float64)
    fk = rng.integers(0, n, n, dtype=np.uint32)
    yf = rng.integers(0, 2**32, n, dtype=np.uint32).view(np.float32)
    y = rng.integers(0, 2**32, n, dtype=np.uint32)
    jl, tl, jr, tr = host_tables(l={"fk": fk, "yf": yf, "y": y}, r={"pk": pk, "xf": xf})
    calls = {"fused": 0}
    _spy(monkeypatch, tplan.HashJoin, "_fused_filter_join", calls, "fused")
    out = tplan.HashJoin(tplan.Filter(tplan.Source(tl), "y"), tplan.Source(tr)).execute(ds)
    assert calls["fused"] == 1, "float payloads fell off the fused tier"
    b = out.concat()
    assert to_numpy(b["yf"]).dtype == np.float32 and to_numpy(b["xf"]).dtype == np.float64
    # raw random bits hold NaN and inf: canon compares the bit patterns
    want = jplan.HashJoin(jplan.Filter(jplan.Source(jl), "y"), jplan.Source(jr)).execute(jds)
    assert_same_rows(out, want)


def test_take_sum_orderfree_fused_tier(ds, jds, monkeypatch):
    rng = np.random.default_rng(9)
    n, k, nb = 16 << 10, 8 << 10, 3
    jdata = JTable([JBatch.from_numpy({"a": rng.integers(0, 2**32, n, dtype=np.uint32)})
                    for _ in range(nb)])
    jidx = JTable([JBatch.from_numpy({"i": rng.integers(0, n, k, dtype=np.uint32)})
                   for _ in range(nb)])
    data, idx = port(jdata), port(jidx)
    calls = {"fused": 0}
    _spy(monkeypatch, tplan.Aggregate, "_take_sum_stream", calls, "fused")
    got = tplan.Aggregate(tplan.TakeNode(tplan.Source(data), tplan.Source(idx)), "a").scalar(ds)
    assert calls["fused"] == 1, "take->sum did not take the order-free tier"
    want = jplan.Aggregate(jplan.TakeNode(jplan.Source(jdata), jplan.Source(jidx)), "a").scalar(jds)
    assert got == want
    tn = tplan.TakeNode(tplan.Source(data), tplan.Source(idx))
    tn._run(ds)  # a cached TakeNode: the materializing tier
    assert tplan.Aggregate(tn, "a").scalar(ds) == want


def test_device_resident_plan_chain(ds, jds, monkeypatch):
    # Filter -> HashJoin -> Aggregate with a materialized (cached) filter:
    # intermediates pass between nodes as device columns, the join runs the
    # device-resident tier (no JoinGpu) and the aggregate sums in place (no
    # SumGpu)
    from dpu_olap_tpu_torch.operators import aggr_op, join_op

    rng = np.random.default_rng(13)
    n = 1 << 12
    pk = np.arange(n, dtype=np.uint32)
    x = rng.integers(0, 2**31 - 2, n, dtype=np.uint32)
    fk = rng.integers(0, n, 4 * n, dtype=np.uint32)
    y = rng.integers(0, 2**32, 4 * n, dtype=np.uint32)
    jl, tl, jr, tr = host_tables(l={"fk": fk, "y": y}, r={"pk": pk, "x": x})

    jf = jplan.Filter(jplan.Source(jl), "y")
    jf._run(jds)
    jj = jplan.HashJoin(jf, jplan.Source(jr))
    want_rows = jj._run(jds)
    want = jplan.Aggregate(jj, "x").scalar(jds)

    fnode = tplan.Filter(tplan.Source(tl), "y")
    assert fnode._run(ds).is_device

    class Boom:
        def __init__(self, *a, **k):
            raise AssertionError("materializing operator used in the device chain")

    monkeypatch.setattr(join_op, "JoinGpu", Boom)
    monkeypatch.setattr(aggr_op, "SumGpu", Boom)
    jnode = tplan.HashJoin(fnode, tplan.Source(tr))
    jtab = jnode._run(ds)
    assert jtab.is_device, "join result left the device"
    assert tplan.Aggregate(jnode, "x").scalar(ds) == want
    assert_same_rows(jtab.to_host(), want_rows)


def _resident_tables(route: str, share: float = 0.8, batch: int = 700):
    """Device-resident (fk, y) and (pk, x) Tables of several batches for
    each route of the device tier: a sorted pk (the sorted-build join), a
    permuted one (the co-sort join, keys31), and a key above 2^31 - 1 (the
    generic join); about ``share`` of the fks with a pk."""
    rng = np.random.default_rng({"sorted_build": 1, "fused": 2, "generic": 3}[route])
    n_r, n_l = 1000, 3000
    pk = np.sort(rng.choice(2**31 - 1, size=n_r, replace=False)).astype(np.uint32)
    if route != "sorted_build":
        pk = rng.permutation(pk)
    if route == "generic":
        pk[7] = 0xFFFFFFF0
    fk = np.where(rng.random(n_l) < share, pk[rng.integers(0, n_r, n_l)],
                  rng.integers(0, 2**31 - 1, n_l)).astype(np.uint32)
    y, x = (rng.integers(0, 2**32, k, dtype=np.uint32) for k in (n_l, n_r))

    def table(names, cols):
        return Table([Batch({n: torch.from_numpy(c[i:i + batch]) for n, c in zip(names, cols)})
                      for i in range(0, cols[0].shape[0], batch)])

    return table(("fk", "y"), (fk, y)), table(("pk", "x"), (pk, x))


@pytest.mark.parametrize("share", [0.8, 0.1])
@pytest.mark.parametrize("route", ["sorted_build", "fused", "generic"])
def test_device_join_compacts_in_the_join(ds, route, share, monkeypatch):
    """The device tier's Table is the one _compact_device made of the padded
    join, row for row and in order: with keys31 the join's last kernel
    writes only the matched rows (no _compact_device), the generic join
    still compacts through _compact_device. Where fewer than half the probe
    rows match, the keys31 Table's columns hold only their rows, not views
    of the probe side's size."""
    from dpu_olap_tpu_torch.ops import fill_match_cuda, join, merge

    lt, rt = _resident_tables(route, share)
    assert lt.is_device and rt.is_device
    lc, rc = lt.concat(), rt.concat()
    if route == "generic":
        fk, lcols, rcols, matched = join.join_shard_fused(lc["fk"], (lc["y"],), rc["pk"],
                                                          (rc["x"],))
    else:
        args = (lc["fk"], (lc["y"],), rc["pk"], (rc["x"],))
        planes = (merge.sorted_build_planes(*args) if route == "sorted_build"
                  else join.cosort_k2(*args))
        fk, lcols, rcols, matched = fill_match_cuda.fill_match_k2(planes, 1, 1)
    want = tplan._compact_device(matched, {"fk": fk, "y": lcols[0], "x": rcols[0]})

    calls = {"compact": 0}
    compact = tplan._compact_device

    def spy(*a):
        calls["compact"] += 1
        return compact(*a)

    monkeypatch.setattr(tplan, "_compact_device", spy)
    before = metrics.counts()
    got = tplan.HashJoin(tplan.Source(lt), tplan.Source(rt))._run(ds)
    counted = {k: v - before.get(k, 0) for k, v in metrics.counts().items()
               if v != before.get(k, 0) and k.startswith(("join.", "readback.plan.compact"))}
    assert calls == {"compact": int(route == "generic")}
    want_counts = {"readback.plan.compact": 1}
    if route != "generic":
        want_counts["join.fill_match_compact"] = 1
    assert counted == want_counts
    assert got.is_device and len(got) == 1 and list(got.names) == ["fk", "y", "x"]
    assert 0 < want["fk"].shape[0] < lc.num_rows
    c = want["fk"].shape[0]
    assert (2 * c < lc.num_rows) == (share < 0.5)
    for n in ("fk", "y", "x"):
        assert got[0][n].dtype == torch.uint32
        assert torch.equal(got[0][n].view(torch.int32), want[n].view(torch.int32)), n
        if route != "generic":
            held = got[0][n].untyped_storage().nbytes()
            assert held == 4 * (c if share < 0.5 else lc.num_rows), n


def test_aggregate_plan_float_double(ds, jds):
    rng = np.random.default_rng(21)
    a = (rng.random(1 << 12) * 1000).astype(np.float64)
    jt, t = host_tables(t={"a": a})
    got = tplan.Aggregate(tplan.Source(t), "a").scalar(ds)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, jplan.Aggregate(jplan.Source(jt), "a").scalar(jds),
                               rtol=F32_RTOL)
    # through a Filter on another (u32) column: not the u64 streaming tier
    b = rng.integers(0, 2**32, 1 << 12, dtype=np.uint32)
    jt2, t2 = host_tables(t={"a": a, "b": b})
    got2 = tplan.Aggregate(tplan.Filter(tplan.Source(t2), "b"), "a").scalar(ds)
    want2 = jplan.Aggregate(jplan.Filter(jplan.Source(jt2), "b"), "a").scalar(jds)
    assert isinstance(got2, float)
    np.testing.assert_allclose(got2, want2, rtol=F32_RTOL)
    np.testing.assert_allclose(got2, a[b < np.uint32(1 << 30)].sum(), rtol=F32_RTOL)


def test_hashjoin_on_several_devices_raises(ds):
    """Once a raise (plans over several devices were not ported): on two
    devices HashJoin now skips its fused tier, as the JAX plan does on a
    mesh, and gives the JAX plan's rows on its two-device mesh."""
    import jax

    left, right = make_join_tables(2, 256, 256)
    jds2 = JaxDeviceSet(jax.devices()[:2])
    lt = tplan.Filter(tplan.Source(port(left)), "y")  # a transform: the fused tier's shape
    got = tplan.HashJoin(lt, tplan.Source(port(right))).execute(
        DeviceSet([torch.device("cpu")] * 2))
    want = jplan.HashJoin(jplan.Filter(jplan.Source(left), "y"), jplan.Source(right)).execute(jds2)
    assert len(got) == 1 and not got.is_device  # JoinGpu's host table
    cols = ("fk", "y", "x")
    g, w = got[0].to_numpy(), want[0]
    assert len(g["fk"]) == len(np.asarray(w["fk"])) > 0
    rows = lambda b: np.stack([np.asarray(b[c]) for c in cols])  # noqa: E731
    gr, wr = rows(g), rows(w)
    np.testing.assert_array_equal(gr[:, np.lexsort(gr[::-1])], wr[:, np.lexsort(wr[::-1])])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_batch_select_add_column_take_slice(as_tensor):
    rng = np.random.default_rng(17)
    n = 1000
    cols = {"a": rng.integers(0, 2**32, n, dtype=np.uint32),
            "f": rng.random(n).astype(np.float32),
            "w": rng.integers(0, 2**63, n, dtype=np.int64)}
    jb = JBatch.from_numpy(cols)
    b = Batch.from_numpy(cols, device="cpu" if as_tensor else None)
    idx = rng.integers(0, n, 300, dtype=np.uint32)
    extra = rng.integers(0, 2**32, n, dtype=np.uint32)

    def same(got, want):
        assert got.names == want.names
        for nm in got.names:
            g, w = to_numpy(got[nm]), np.asarray(want[nm])
            assert isinstance(got[nm], torch.Tensor) == as_tensor
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    same(b.select(["w", "a"]), jb.select(["w", "a"]))
    taken = b.take(torch.from_numpy(idx) if as_tensor else idx)
    # JAX keeps 64-bit integers only with x64 on: the int64 column is held
    # to numpy, the 4-byte ones to the JAX Batch too
    same(taken, Batch.from_numpy({nm: c[idx] for nm, c in cols.items()}))
    same(taken.select(["a", "f"]), jb.select(["a", "f"]).take(idx))
    same(b.slice(100, 250), jb.slice(100, 250))
    x = torch.from_numpy(extra) if as_tensor else extra
    same(b.add_column("x", x), jb.add_column("x", extra))
    same(b.add_column("x", x, index=0), jb.add_column("x", extra, index=0))
