"""The port over several devices (dpu_olap_tpu_torch.parallel.mesh,
shuffle, dist_join, partitioner and the operators on a DeviceSet of d CPU
devices, the counterpart of the JAX tests' 8-device virtual CPU mesh)
against the JAX package on its mesh and against pyarrow. The same numpy
inputs go to both; each port result is a tuple of shards, compared device
block by device block with the JAX package's global arrays: the shuffle's
keys, payloads and counts bit for bit; a join's matched mask and keys bit
for bit and its rows after a canonical sort (ties in the JAX sort may
permute payloads); operators equal to their Tpu twins and to pyarrow."""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dpu_olap_tpu.columnar import Batch as JaxBatch
from dpu_olap_tpu.columnar import Table as JaxTable
from dpu_olap_tpu.generator import make_filter_batches as jax_make_filter_batches
from dpu_olap_tpu.generator import make_join_tables as jax_make_join_tables
from dpu_olap_tpu.generator import make_take_batches as jax_make_take_batches
from dpu_olap_tpu.operators import FilterTpu, JoinTpu, PartitionTpu, SumTpu, TakeTpu
from dpu_olap_tpu.parallel import shuffle as jshuffle
from dpu_olap_tpu.parallel.dist_join import dist_join as jax_dist_join
from dpu_olap_tpu.parallel.mesh import AXIS
from dpu_olap_tpu.parallel.mesh import DeviceSet as JaxDeviceSet
from dpu_olap_tpu.parallel.partitioner import Partitioner as JaxPartitioner
from dpu_olap_tpu.parallel.partitioner import ResidentPartitioner as JaxResidentPartitioner
from dpu_olap_tpu_torch import config
from dpu_olap_tpu_torch.columnar import Batch, Table
from dpu_olap_tpu_torch.config import FLAGS
from dpu_olap_tpu_torch.metrics import counts
from dpu_olap_tpu_torch.operators import PartitionGpu
from dpu_olap_tpu_torch.operators.aggr_op import SumGpu, SumNative
from dpu_olap_tpu_torch.operators.filter_op import FilterGpu, FilterNative
from dpu_olap_tpu_torch.operators.join_op import JoinGpu, JoinNative
from dpu_olap_tpu_torch.operators.take_op import TakeGpu, TakeNative
from dpu_olap_tpu_torch.parallel import shuffle
from dpu_olap_tpu_torch.parallel.dist_join import dist_join, dist_join_phase_ms
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet
from dpu_olap_tpu_torch.parallel.partitioner import Partitioner, ResidentPartitioner


def cpu_set(d):
    return DeviceSet([torch.device("cpu")] * d)


def jax_set(d):
    return JaxDeviceSet(jax.devices()[:d])


def canon(cols):
    rows = np.stack([np.asarray(c) for c in cols])
    return rows[:, np.lexsort(rows[::-1])]


def blocks(shards):
    """A tuple of shards as one host array, device block after block."""
    return np.concatenate([s.numpy() for s in shards])


# ---- the DeviceSet contract -----------------------------------------------


def test_device_set_of_several_devices():
    one = DeviceSet("cpu")
    assert one.nr_devices == 1 and one.devices == (torch.device("cpu"),)
    ds = cpu_set(4)
    assert ds.nr_devices == 4 and ds.device == torch.device("cpu")
    assert ds.physical == (torch.device("cpu"),)
    a = np.arange(40, dtype=np.uint32)
    shards = ds.split(a)
    assert len(shards) == 4 and all(s.shape == (10,) and s.dtype == torch.uint32 for s in shards)
    np.testing.assert_array_equal(shards[2].numpy(), a[20:30])
    np.testing.assert_array_equal(DeviceSet.gather(shards), a)
    np.testing.assert_array_equal(DeviceSet.gather(ds.split(torch.from_numpy(a))), a)
    np.testing.assert_array_equal(DeviceSet.gather(shards[1]), a[10:20])
    np.testing.assert_array_equal(ds.scatter(a).numpy(), a)
    with pytest.raises(ValueError, match="do not split over 4"):
        ds.split(a[:39])
    with pytest.raises(ValueError, match="at least one device"):
        DeviceSet([])
    ds.sync()


def test_allocate_raises_without_enough_cuda_devices(monkeypatch):
    monkeypatch.delenv("NR_DEVICES", raising=False)
    monkeypatch.delenv("NR_DPUS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSet.allocate(1)
    # one card: the first device, never a repeat or the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert DeviceSet.allocate().devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="requested 4 devices, have 1"):
        DeviceSet.allocate(4)
    monkeypatch.setenv("NR_DEVICES", "2")
    assert config.nr_devices(default=1) == 2
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        DeviceSet.allocate()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert DeviceSet.allocate().devices == (torch.device("cuda", 0), torch.device("cuda", 1))


# ---- the exchange and the shuffle -----------------------------------------


def test_exchange_is_the_tiled_all_to_all():
    d, k = 4, 3
    blocks_in = [torch.arange(d * k * 2, dtype=torch.int32).reshape(d * k, 2) + 100 * s
                 for s in range(d)]
    before = counts()
    recv = shuffle.exchange(blocks_in)
    for t in range(d):
        want = torch.cat([b[t * k:(t + 1) * k] for b in blocks_in])
        assert torch.equal(recv[t], want)
    after = counts()
    # one cat a destination on one device
    assert after["exchange.copies"] - before.get("exchange.copies", 0) == d
    assert (after["exchange.bytes"] - before.get("exchange.bytes", 0)
            == sum(b.numel() * 4 for b in blocks_in))
    # split and concat on the second axis (the 2-D shuffle's first stage)
    wide = [b.reshape(k, d * 2) for b in blocks_in]
    recv = shuffle.exchange(wide, split_axis=1, concat_axis=1)
    for t in range(d):
        assert torch.equal(recv[t], torch.cat([w[:, 2 * t:2 * t + 2] for w in wide], dim=1))
    # the peer-copy form, taken where devices differ, lays the same block
    pieces = [w[:, 2:4] for w in wide]
    for axis in (0, 1):
        assert torch.equal(shuffle._peer_copy(pieces, torch.device("cpu"), axis),
                           torch.cat(pieces, dim=axis))


def _jax_shuffle(d, keys, pay, cell, rounds, inband):
    jds = jax_set(d)
    fn = jds.shard_fn(
        lambda k, q: jshuffle.shuffle_partitions(k, (q,), d, cell, rounds=rounds,
                                                 counts_inband=inband),
        in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS),
    )
    return fn(jds.scatter(keys), jds.scatter(pay))


@pytest.mark.parametrize("inband", [False, True], ids=["counts_apart", "counts_inband"])
@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_shuffle_partitions_matches_jax(d, rounds, inband):
    rng = np.random.default_rng(100 * d + rounds)
    n = d * 1024
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    pay = np.arange(n, dtype=np.uint32)  # the global row as payload
    cell = shuffle.default_cell_size(n // d, d * rounds, 2.0)
    ds = cpu_set(d)
    res = shuffle.shuffle_partitions(ds.split(keys), (ds.split(pay),), d, cell, rounds=rounds,
                                     counts_inband=inband)
    jres = _jax_shuffle(d, keys, pay, cell, rounds, inband)
    assert len(res) == d and all(r.rounds == rounds for r in res)
    np.testing.assert_array_equal(blocks([r.keys for r in res]), np.asarray(jres.keys))
    np.testing.assert_array_equal(blocks([r.payloads[0] for r in res]),
                                  np.asarray(jres.payloads[0]))
    np.testing.assert_array_equal(blocks([r.counts for r in res]), np.asarray(jres.counts))
    np.testing.assert_array_equal(blocks([r.overflow for r in res]), np.asarray(jres.overflow))
    # each device's resident round planes, as the JAX package's per device
    jplanes = np.asarray(jres.keys).reshape(d, d * rounds, cell)
    for t, r in enumerate(res):
        rk, (rp,), rv = r.round_planes()
        want = jplanes[t].reshape(d, rounds, cell).transpose(1, 0, 2).reshape(rounds, d * cell)
        np.testing.assert_array_equal(rk.numpy(), want)
        assert int(rv.sum()) == int(r.counts.to(torch.int64).sum())
    assert sum(int(r.counts.to(torch.int64).sum()) for r in res) == n
    # the flag form gives the same result
    FLAGS.shuffle_counts_inband = not inband
    try:
        other = shuffle.shuffle_partitions(ds.split(keys), (ds.split(pay),), d, cell,
                                           rounds=rounds)
    finally:
        FLAGS.shuffle_counts_inband = False
    for a, b in zip(res, other):
        assert torch.equal(a.keys, b.keys) and torch.equal(a.counts, b.counts)
        assert torch.equal(a.payloads[0], b.payloads[0])


def test_shuffle_refuses_mismatched_partitions():
    ds = cpu_set(2)
    keys = np.arange(256, dtype=np.uint32)
    with pytest.raises(ValueError, match="2 shards take nr_partitions 2"):
        shuffle.shuffle_partitions(ds.split(keys), (), 4, 256)
    with pytest.raises(ValueError, match="tuple of shards"):
        shuffle.shuffle_partitions(torch.from_numpy(keys), (), 2, 256)


# ---- the shuffle join -----------------------------------------------------


def _tables(n_b=8, bl=1 << 11, br=1 << 10):
    left, right = jax_make_join_tables(n_b, bl, br)
    lf, rt = left.concat(), right.concat()
    return left, right, [np.asarray(lf[c]) for c in ("fk", "y")], \
        [np.asarray(rt[c]) for c in ("pk", "x")]


@pytest.fixture(scope="module")
def join_inputs():
    return _tables()


def _check_per_device(d, res, jres, exact_rows):
    """The port's shards against the JAX package's global arrays, device
    block by device block."""
    fk, (y,), (x,), matched, overflow = res
    jfk, (jy,), (jx,), jm, jovf = (np.asarray(a) if not isinstance(a, tuple) else
                                   tuple(np.asarray(c) for c in a) for a in jres)
    assert len(fk) == d and not blocks(overflow).any() and not jovf.any()
    m = blocks(matched)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(blocks(fk), jfk)
    per = len(m) // d
    got = [blocks(fk), blocks(y), blocks(x)]
    want = [jfk, jy, jx]
    for t in range(d):
        sl = slice(t * per, (t + 1) * per)
        mm = m[sl]
        g = [c[sl][mm] for c in got]
        w = [c[sl][mm] for c in want]
        if exact_rows:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:  # key-sorted rows: equal keys may permute payloads
            np.testing.assert_array_equal(canon(g), canon(w))
    return [c[m] for c in got]


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("impl", ["cosort", "sort", "cuckoo"])
def test_dist_join_matches_jax_and_arrow(join_inputs, impl, rounds):
    d = 8
    left, right, (lfk, ly), (rpk, rx) = join_inputs
    res = dist_join(cpu_set(d), lfk, (ly,), rpk, (rx,), impl=impl, rounds=rounds)
    jres = jax_dist_join(jax_set(d), jnp.asarray(lfk), (jnp.asarray(ly),), jnp.asarray(rpk),
                         (jnp.asarray(rx),), impl=impl, rounds=rounds)
    fk, y, x = _check_per_device(d, res, jres, exact_rows=impl != "cosort")
    assert len(fk) == len(lfk)  # guaranteed-match inner join: every left row
    expect = pa.Table.from_batches([b.to_arrow() for b in left]).join(
        pa.Table.from_batches([b.to_arrow() for b in right]),
        keys="fk", right_keys="pk", join_type="inner")
    np.testing.assert_array_equal(canon([fk, y, x]),
                                  canon([expect[c].to_numpy() for c in ("fk", "y", "x")]))


def _skewed(n, seed):
    rng = np.random.default_rng(seed)
    pk = np.arange(n, dtype=np.uint32)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    fk = np.where(rng.random(n) < 0.4, np.uint32(rng.integers(0, n)),
                  rng.integers(0, n, n).astype(np.uint32))
    return fk, np.arange(n, dtype=np.uint32), pk, x


def test_skewed_keys_overflow_then_join_gpu_retries():
    # 40% of fks on one hot key (__graft_entry__.py's skewed case): the
    # default cells overflow on both packages, and the operators' cell
    # doubling retry joins every row
    d, n = 4, 4 * 1024
    fk, y, pk, x = _skewed(n, 3)
    res = dist_join(cpu_set(d), fk, (y,), pk, (x,))
    jres = jax_dist_join(jax_set(d), jnp.asarray(fk), (jnp.asarray(y),), jnp.asarray(pk),
                         (jnp.asarray(x),))
    np.testing.assert_array_equal(blocks(res[4]), np.asarray(jres[4]))
    assert blocks(res[4]).any()
    res = dist_join(cpu_set(d), fk, (y,), pk, (x,), cell_left=2 * n // d)
    jres = jax_dist_join(jax_set(d), jnp.asarray(fk), (jnp.asarray(y),), jnp.asarray(pk),
                         (jnp.asarray(x),), cell_left=2 * n // d)
    fko, yo, xo = _check_per_device(d, res, jres, exact_rows=False)
    np.testing.assert_array_equal(xo, x[fko])
    left = [{"fk": fk[i::d], "y": y[i::d]} for i in range(d)]
    right = [{"pk": pk[i::d], "x": x[i::d]} for i in range(d)]
    op = JoinGpu(cpu_set(d), Table([Batch.from_numpy(b) for b in left]),
                 Table([Batch.from_numpy(b) for b in right])).Prepare()
    out = op.Run()
    jout = JoinTpu(jax_set(d), JaxTable([JaxBatch.from_numpy(b) for b in left]),
                   JaxTable([JaxBatch.from_numpy(b) for b in right])).Prepare().Run()
    assert len(out["fk"]) == n
    np.testing.assert_array_equal(canon([out[c] for c in ("fk", "y", "x")]),
                                  canon([jout[c] for c in ("fk", "y", "x")]))
    np.testing.assert_array_equal(out["x"], x[out["fk"]])


# ---- JoinGpu over several devices -----------------------------------------


@pytest.mark.parametrize("path", ["ici", "ici_rounds2", "partitioned", "sort"])
def test_join_gpu_matches_join_tpu_and_arrow(path):
    d = 4
    jleft, jright = jax_make_join_tables(8, 1 << 10, 1 << 10)
    left, right = Table.from_reference(jleft), Table.from_reference(jright)
    impl = "sort" if path == "sort" else "cosort"
    op = JoinGpu(cpu_set(d), left, right, impl=impl).Prepare()
    jop = JoinTpu(jax_set(d), jleft, jright, impl=impl).Prepare()
    run = {"ici": lambda o: o.Run(), "sort": lambda o: o.Run(),
           "ici_rounds2": lambda o: o._run_ici(rounds=2),
           "partitioned": lambda o: o._run_partitioned()}[path]
    out, jout = run(op), run(jop)
    cols = ("fk", "y", "x")
    assert len(out["fk"]) == len(jout["fk"]) == left.num_rows
    np.testing.assert_array_equal(canon([out[c] for c in cols]), canon([jout[c] for c in cols]))
    nat = JoinNative(left, right).Prepare().Run()
    np.testing.assert_array_equal(canon([out[c] for c in cols]),
                                  canon([nat[c].to_numpy() for c in cols]))
    if path == "partitioned":  # rounds of d partition pairs, device by device
        for c in cols:
            np.testing.assert_array_equal(np.sort(out[c]), np.sort(jout[c]))
        assert op.Timers().rank_count("build-probe-take") == 2
    else:
        assert op.Timers().sum_ns("join-total") > 0


def test_join_phase_timers_over_several_devices(monkeypatch):
    monkeypatch.setattr(FLAGS, "join_timers", True)
    left, right = jax_make_join_tables(4, 1 << 10, 1 << 10)
    op = JoinGpu(cpu_set(4), Table.from_reference(left), Table.from_reference(right),
                 impl="sort").Prepare()
    op.Run()
    assert list(op.phase_ms) == ["fragments-ms", "exchange-ms", "local-join-ms"]
    assert all(np.isfinite(v) for v in op.phase_ms.values())
    # the carry may also come as shards
    ds = cpu_set(2)
    lf = np.asarray(left.concat()["fk"])
    ms = dist_join_phase_ms(ds, ds.split(lf), ds.split(lf), 1, 1, 512, 512, k=1)
    assert sum(ms.values()) > 0


# ---- the partition engines and PartitionGpu --------------------------------


def _same_parts(got, want, names):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for nm in names:
            assert g[nm].dtype == np.uint32
            np.testing.assert_array_equal(g[nm], np.asarray(w[nm]))


@pytest.mark.parametrize("p", [8, 16])
def test_partitioners_match_jax(p):
    d = 4
    jleft, _ = jax_make_join_tables(8, 1 << 11, 1 << 10)
    left = Table.from_reference(jleft)
    host = Partitioner(cpu_set(d), p).partition_table(left, "fk", ["y"])
    jhost = JaxPartitioner(jax_set(d), p).partition_table(jleft, "fk", ["y"])
    _same_parts(host, jhost, ["fk", "y"])
    dparts = ResidentPartitioner(cpu_set(d), p).partition_table(left, "fk", ["y"])
    jdparts = JaxResidentPartitioner(jax_set(d), p).partition_table(jleft, "fk", ["y"])
    assert dparts.rounds == p // d and len(dparts.keys) == d
    np.testing.assert_array_equal(blocks(dparts.keys), np.asarray(jdparts.keys))
    np.testing.assert_array_equal(blocks(dparts.counts), np.asarray(jdparts.counts))
    np.testing.assert_array_equal(dparts.partition_rows(), jdparts.partition_rows())
    _same_parts(dparts.to_host(), jdparts.to_host(), ["fk", "y"])
    dparts.sync()
    with pytest.raises(ValueError, match="do not divide over 3"):
        Partitioner(cpu_set(3), p).partition_table(left, "fk")


@pytest.mark.parametrize("resident", [True, False])
def test_partition_gpu_matches_partition_tpu(resident):
    d, p = 4, 16
    jleft, _ = jax_make_join_tables(8, 1 << 11, 1 << 10)
    left = Table.from_reference(jleft)
    out = PartitionGpu(cpu_set(d), left, "fk", p, resident=resident).Prepare().Run()
    jout = PartitionTpu(jax_set(d), jleft, "fk", p, resident=resident).Prepare().Run()
    if resident:
        out, jout = out.to_host(), jout.to_host()
    _same_parts(out, jout, ["fk", "y"])
    assert sum(len(q["fk"]) for q in out) == left.num_rows
    with pytest.raises(OverflowError, match="shuffle_slack"):
        same_key = Table([Batch.from_numpy({"k": np.zeros(1024, np.uint32)})] * d)
        PartitionGpu(cpu_set(d), same_key, "k", 8, resident=resident).Prepare().Run()


# ---- the streaming operators: d * rpr batches a round ----------------------


@pytest.fixture
def four_rounds(monkeypatch):
    # 16 batches over 4 devices, 2 a device a round: 4 rounds of 8
    monkeypatch.setattr(FLAGS, "stream_round_rows", 8 << 10)


def test_filter_gpu_over_several_devices(four_rounds):
    d = 4
    jtable = jax_make_filter_batches(num_batches=16, batch_size=1 << 10)
    table = Table.from_reference(jtable)
    op = FilterGpu(cpu_set(d), table).Prepare()
    got = op.Run()
    assert (op.rpr, op.n_rounds) == (2, 2)
    jgot = FilterTpu(jax_set(d), jtable).Prepare().Run()
    nat = FilterNative(table).Prepare().Run()
    assert len(got) == len(jgot) == len(nat) == 16
    for g, j, e in zip(got, jgot, nat):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("dtype", ["u32", "f32"])
def test_sum_gpu_over_several_devices(four_rounds, dtype):
    d = 4
    rng = np.random.default_rng(5)
    if dtype == "u32":
        cols = [rng.integers(0, 2**32, 1 << 10, dtype=np.uint32) for _ in range(16)]
    else:
        cols = [rng.random(1 << 10, dtype=np.float32) for _ in range(16)]
    table = Table([Batch.from_numpy({"a": c}) for c in cols])
    jtable = JaxTable([JaxBatch.from_numpy({"a": c}) for c in cols])
    got = SumGpu(cpu_set(d), table).Prepare().Run()
    want = SumTpu(jax_set(d), jtable).Prepare().Run()
    nat = SumNative(table).Prepare().Run()
    if dtype == "u32":
        assert got == want == nat == int(sum(c.astype(np.uint64).sum() for c in cols))
    else:  # f32 block partials summed in another order than XLA's
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, nat, rtol=1e-5)


def test_take_gpu_over_several_devices(four_rounds):
    d = 4
    jdata, jidx = jax_make_take_batches(num_batches=16, batch_size=1 << 10, indices_size=1 << 8)
    data, idx = Table.from_reference(jdata), Table.from_reference(jidx)
    op = TakeGpu(cpu_set(d), data, idx).Prepare()
    got = op.Run()
    assert op.n_rounds == 2
    jgot = TakeTpu(jax_set(d), jdata, jidx).Prepare().Run()
    nat = TakeNative(data, idx).Prepare().Run()
    assert len(got) == len(jgot) == len(nat) == 16
    for g, j, e in zip(got, jgot, nat):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, e)


# ---- the plan over several devices ------------------------------------------


def test_plan_over_several_devices():
    import dpu_olap_tpu.plan as jplan
    from dpu_olap_tpu_torch import plan as tplan

    d = 4
    jleft, jright = jax_make_join_tables(4, 1 << 10, 1 << 10)
    left, right = Table.from_reference(jleft), Table.from_reference(jright)
    ds, jds = cpu_set(d), jax_set(d)
    # HashJoin skips its fused and device-resident tiers for JoinGpu
    got = tplan.HashJoin(tplan.Filter(tplan.Source(left), "y"), tplan.Source(right)).execute(ds)
    want = jplan.HashJoin(jplan.Filter(jplan.Source(jleft), "y"), jplan.Source(jright)).execute(jds)
    cols = ("fk", "y", "x")
    np.testing.assert_array_equal(canon([got[0][c] for c in cols]),
                                  canon([np.asarray(want[0][c]) for c in cols]))
    # Repartition takes the resident engine over every device
    got = tplan.Repartition(tplan.Source(left), "fk", 8).execute(ds)
    want = jplan.Repartition(jplan.Source(jleft), "fk", 8).execute(jds)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for c in ("fk", "y"):
            np.testing.assert_array_equal(np.asarray(g[c]), np.asarray(w[c]))
    # an aggregate over the join runs on the set's first device
    total = tplan.Aggregate(tplan.HashJoin(tplan.Source(left), tplan.Source(right)), "x").scalar(ds)
    jtotal = jplan.Aggregate(jplan.HashJoin(jplan.Source(jleft), jplan.Source(jright)),
                             "x").scalar(jds)
    assert total == jtotal
