"""Parity of the port's joins (dpu_olap_tpu_torch.ops.merge and
operators.join_op) with the JAX package's join_shard_dense / JoinTpu and the
pyarrow oracle, on the CPU: the dense-pk path and, for any other pk, the
sorted-build and fused fallbacks. Integer data: exact comparison, rows after a
canonical sort (both sorts are unstable on ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.generator import make_join_tables as jax_make_join_tables
from dpu_olap_tpu.operators.join_op import JoinTpu
from dpu_olap_tpu.ops.merge_xla import join_shard_dense as jax_join_shard_dense
from dpu_olap_tpu.parallel.mesh import DeviceSet as JaxDeviceSet
from dpu_olap_tpu_torch.columnar import Table
from dpu_olap_tpu_torch.generator import make_join_tables
from dpu_olap_tpu_torch.operators.join_op import JoinGpu, JoinNative
from dpu_olap_tpu_torch.ops.merge import join_dense_eligible, join_shard_dense
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

CPU_SET = DeviceSet(torch.device("cpu"))


def _canon(cols):
    rows = np.stack([np.asarray(c) for c in cols])
    return rows[:, np.lexsort(rows[::-1])]


def _dense_case(name):
    rng = np.random.default_rng(7)
    if name == "generator":  # tests/test_join.py:246-268
        left, right = jax_make_join_tables(1, 1 << 13, 1 << 12)
        lb, rb = left[0], right[0]
        return [lb["fk"]], [lb["y"]], rb["pk"], [rb["x"]]
    n_r, n_l, lo = 1 << 12, 1 << 13, 1000  # tests/test_join.py:271-296
    pk = np.arange(lo, lo + n_r, dtype=np.uint32)
    # fks below pk0 wrap huge and must sort to the tail, unmatched
    fk = rng.integers(0, lo + n_r + 500, n_l, dtype=np.uint32)
    n_pay = 2 if name == "two_payloads" else 1
    xs = [rng.integers(0, 2**32, n_r, dtype=np.uint32) for _ in range(n_pay)]
    ys = [rng.integers(0, 2**32, n_l, dtype=np.uint32) for _ in range(n_pay)]
    return [fk], ys, pk, xs


@pytest.mark.parametrize("case", ["generator", "unmatched_and_offset", "two_payloads"])
def test_join_shard_dense_matches_jax(case):
    (fk,), ys, pk, xs = _dense_case(case)
    fk, pk = np.asarray(fk), np.asarray(pk)
    ys, xs = [np.asarray(y) for y in ys], [np.asarray(x) for x in xs]
    t = torch.from_numpy
    key, out_l, out_r, matched, ovf = join_shard_dense(
        t(fk), tuple(map(t, ys)), t(pk), tuple(map(t, xs))
    )
    jkey, jl, jr, jm, jovf = jax_join_shard_dense(
        jnp.asarray(fk), tuple(map(jnp.asarray, ys)),
        jnp.asarray(pk), tuple(map(jnp.asarray, xs)), interpret=True,
    )
    assert int(ovf) == 0 and int(jovf) == 0
    assert key.dtype == torch.uint32 and matched.dtype == torch.bool
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        _canon([key.numpy(), *(c.numpy() for c in out_l), *(c.numpy() for c in out_r)]),
        _canon([np.asarray(jkey), *map(np.asarray, jl), *map(np.asarray, jr)]),
    )
    # the dense truth, independent of both packages
    m = matched.numpy()
    in_range = (fk >= pk[0]) & (fk.astype(np.int64) < int(pk[0]) + len(pk))
    assert m.sum() == in_range.sum()
    kf = key.numpy()[m].astype(np.int64)
    for x, c in zip(xs, out_r):
        np.testing.assert_array_equal(c.numpy()[m], x[kf - pk[0]])
    assert not key.numpy()[~m].any() and all(not c.numpy()[~m].any() for c in out_l)


def test_join_dense_eligible():
    assert join_dense_eligible(2, 1)
    assert not join_dense_eligible(1, 1) and not join_dense_eligible(8, 0)


def _rows(out, cols):
    return _canon([out[c] for c in cols])


@pytest.mark.parametrize("num_batches", [1, 3])
def test_join_gpu_matches_join_tpu_and_native(num_batches):
    left, right = make_join_tables(num_batches, 1 << 12, 1 << 11)
    jleft, jright = jax_make_join_tables(num_batches, 1 << 12, 1 << 11)
    op = JoinGpu(CPU_SET, left, right).Prepare()
    jop = JoinTpu(JaxDeviceSet.allocate(1), jleft, jright).Prepare()
    assert (op.keys31, op.pk_sorted, op.pk_dense) == (jop.keys31, jop.pk_sorted, jop.pk_dense)
    assert op.pk_dense
    out, jout = op.Run(), jop.Run()
    nat = JoinNative(left, right).Prepare().Run()
    cols = ("fk", "y", "x")
    assert len(out["fk"]) == nat.num_rows == num_batches << 12
    np.testing.assert_array_equal(_rows(out, cols), _rows(jout, cols))
    np.testing.assert_array_equal(
        _rows(out, cols), _canon([nat[c].to_numpy() for c in cols])
    )
    assert op.Timers().sum_ns("join-total") > 0 and op.Timers().rank_count("h2d") == 1


def test_join_gpu_wide_payloads_match_join_tpu():
    rng = np.random.default_rng(11)
    nb, bl, br = 2, 1 << 10, 1 << 9
    cols_l, cols_r = [], []
    for i in range(nb):
        cols_l.append({
            "fk": rng.integers(i * br, (i + 1) * br + 64, bl, dtype=np.uint32),
            "y64": rng.integers(0, 2**64, bl, dtype=np.uint64),
            "yf": rng.integers(0, 2**32, bl, dtype=np.uint32).view(np.float32),
        })
        cols_r.append({
            "pk": np.arange(i * br, (i + 1) * br, dtype=np.uint32),
            "xi": rng.integers(-(2**63), 2**63 - 1, br, dtype=np.int64),
            "xf": rng.integers(0, 2**64, br, dtype=np.uint64).view(np.float64),
        })
    from dpu_olap_tpu import columnar as jcol

    jleft = jcol.Table([jcol.Batch.from_numpy(c) for c in cols_l])
    jright = jcol.Table([jcol.Batch.from_numpy(c) for c in cols_r])
    out = JoinGpu(CPU_SET, Table.from_reference(jleft), Table.from_reference(jright)).Prepare().Run()
    jout = JoinTpu(JaxDeviceSet.allocate(1), jleft, jright).Prepare().Run()
    names = ["fk", "y64", "yf", "xi", "xf"]
    assert list(out) == list(jout) == names
    for n in names:
        assert out[n].dtype == jout[n].dtype

    def bits(o):  # compare bit patterns: NaN payloads are not == themselves
        return _canon(
            [o["fk"].astype(np.uint64)] + [o[n].view(np.uint64) if o[n].itemsize == 8
                                           else o[n].view(np.uint32).astype(np.uint64)
                                           for n in names[1:]]
        )

    np.testing.assert_array_equal(bits(out), bits(jout))
    assert len(out["fk"]) < nb * bl  # some fks lie past the last pk


def _fallback_tables(case, nb):
    """(left, right) batches as numpy dicts for the non-dense pk paths."""
    rng = np.random.default_rng(nb * 10 + len(case))
    bl, br = (1, 1 << 9) if case == "one_row_left" else (1 << 10, 1 << 9)
    cols_l, cols_r = [], []
    for i in range(nb):
        if case == "sorted_sparse":  # TPC-H o_orderkey: the first 8 of every 32
            j = np.arange(br, dtype=np.uint32)
            pk = (i * br // 8 + j // 8) * 32 + j % 8 + 1
        elif case == "one_row_left":
            pk = np.arange(i * br, (i + 1) * br, dtype=np.uint32)  # dense
        else:
            pk = rng.permutation(np.arange(i * 2 * br, (i + 1) * 2 * br, dtype=np.uint32))[:br]
            if case.endswith("_sorted"):
                pk = np.sort(pk)
        if case.startswith("keys_top"):
            pk = pk + np.uint32(0x80000000)
        fk = pk[rng.integers(0, br, bl)]
        fk[: bl // 8] += np.uint32(3)  # some miss, some hit another row
        left = {"fk": fk, "y": rng.integers(0, 2**32, bl, dtype=np.uint32)}
        right = {"pk": pk.astype(np.uint32), "x": rng.integers(0, 2**32, br, dtype=np.uint32)}
        if case.startswith("wide"):
            left["y64"] = rng.integers(0, 2**64, bl, dtype=np.uint64)
            left["yf"] = rng.integers(0, 2**32, bl, dtype=np.uint32).view(np.float32)
            right["xi"] = rng.integers(-(2**63), 2**63 - 1, br, dtype=np.int64)
            right["xf"] = rng.integers(0, 2**64, br, dtype=np.uint64).view(np.float64)
        cols_l.append(left)
        cols_r.append(right)
    return cols_l, cols_r


def _bits(cols, names):
    """Rows of bit patterns (NaN payloads are not == themselves)."""
    return _canon([
        np.asarray(cols[n]).view(np.uint64) if np.asarray(cols[n]).itemsize == 8
        else np.asarray(cols[n]).view(np.uint32).astype(np.uint64)
        for n in names
    ])


@pytest.mark.parametrize("case, nb, path", [
    ("sorted_sparse", 1, "sorted-build"),
    ("sorted_sparse", 3, "sorted-build"),
    ("permuted", 1, "fused keys31"),
    ("permuted", 3, "fused keys31"),
    ("keys_top_permuted", 1, "fused generic"),
    ("keys_top_permuted", 3, "fused generic"),
    ("keys_top_sorted", 1, "fused generic"),
    ("one_row_left", 1, "sorted-build"),
    ("wide_sorted", 2, "sorted-build"),
    ("wide_permuted", 1, "fused keys31"),
    ("wide_permuted", 2, "fused keys31"),
])
def test_join_gpu_fallback_matches_join_tpu_and_native(case, nb, path):
    from dpu_olap_tpu import columnar as jcol

    cols_l, cols_r = _fallback_tables(case, nb)
    jleft = jcol.Table([jcol.Batch.from_numpy(c) for c in cols_l])
    jright = jcol.Table([jcol.Batch.from_numpy(c) for c in cols_r])
    left, right = Table.from_reference(jleft), Table.from_reference(jright)
    op = JoinGpu(CPU_SET, left, right).Prepare()
    jop = JoinTpu(JaxDeviceSet.allocate(1), jleft, jright).Prepare()
    flags = (op.keys31, op.pk_sorted, op.pk_dense)
    assert flags == (jop.keys31, jop.pk_sorted, jop.pk_dense)
    assert flags == {
        "sorted-build": (True, True, case == "one_row_left"),
        "fused keys31": (True, False, False),
        "fused generic": (False, case == "keys_top_sorted", False),
    }[path]
    out, jout = op.Run(), jop.Run()
    names = list(cols_l[0]) + [c for c in cols_r[0] if c != "pk"]
    assert list(out) == list(jout) == names
    for n in names:
        assert out[n].dtype == jout[n].dtype
    np.testing.assert_array_equal(_bits(out, names), _bits(jout, names))
    nat = JoinNative(left, right).Prepare().Run()
    assert len(out["fk"]) == nat.num_rows > 0
    np.testing.assert_array_equal(
        _bits(out, names), _bits({n: nat[n].to_numpy() for n in names}, names)
    )
    assert op.Timers().sum_ns("join-total") > 0 and op.Timers().rank_count("h2d") == 1


@pytest.mark.parametrize("rows, path", [(256, "shuffle"), (255, "partitioned")])
def test_join_gpu_multi_device_raises(rows, path):
    class TwoDevices(DeviceSet):
        @property
        def nr_devices(self):
            return 2

    left, right = make_join_tables(1, rows, rows)
    op = JoinGpu(TwoDevices(torch.device("cpu")), left, right).Prepare()
    with pytest.raises(NotImplementedError, match=f"{path}.*item 10"):
        op.Run()


# ---- the shuffle join and the partitioned join (parallel/dist_join.py,
# parallel/partitioner.py) against JoinTpu on a one-device mesh ------------


def _join_tables(nb=4, bl=1 << 10, br=1 << 9):
    jleft, jright = jax_make_join_tables(nb, bl, br)
    return jleft, jright, Table.from_reference(jleft), Table.from_reference(jright)


def _check_join(out, jout, left, right):
    cols = ("fk", "y", "x")
    assert list(out) == list(jout)
    np.testing.assert_array_equal(_rows(out, cols), _rows(jout, cols))
    nat = JoinNative(left, right).Prepare().Run()
    assert len(out["fk"]) == nat.num_rows > 0
    np.testing.assert_array_equal(_rows(out, cols), _canon([nat[c].to_numpy() for c in cols]))


@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_join_gpu_run_ici_matches_join_tpu(rounds):
    jleft, jright, left, right = _join_tables()
    op = JoinGpu(CPU_SET, left, right).Prepare()
    out = op._run_ici(rounds=rounds)
    jout = JoinTpu(JaxDeviceSet.allocate(1), jleft, jright).Prepare()._run_ici(rounds=rounds)
    _check_join(out, jout, left, right)
    assert op.Timers().sum_ns("join-total") > 0 and op.Timers().rank_count("gather-result") == 1


@pytest.mark.parametrize("impl", ["sort", "cuckoo"])
def test_join_gpu_impl_runs_the_shuffle_join_like_join_tpu(impl):
    jleft, jright, left, right = _join_tables()
    op = JoinGpu(CPU_SET, left, right, impl=impl).Prepare()
    out = op.Run()
    jout = JoinTpu(JaxDeviceSet.allocate(1), jleft, jright, impl=impl).Prepare().Run()
    _check_join(out, jout, left, right)
    assert op.Timers().sum_ns("join-total") > 0  # the shuffle join ran (_run_ici)


@pytest.mark.parametrize("impl", ["cosort", "sort"])
def test_join_gpu_partitioned_path_matches_join_tpu(impl):
    # tests/test_operators.py:80-89: shrink the residency budget on the
    # instance so that the host-staged Partitioner + rounds path runs
    jleft, jright, left, right = _join_tables(nb=4, bl=1 << 10, br=1 << 9)
    op = JoinGpu(CPU_SET, left, right, impl=impl).Prepare()
    jop = JoinTpu(JaxDeviceSet.allocate(1), jleft, jright, impl=impl).Prepare()
    op.MAX_RESIDENT_ROWS = jop.MAX_RESIDENT_ROWS = 1 << 10
    out, jout = op.Run(), jop.Run()
    _check_join(out, jout, left, right)
    assert op.Timers().rank_count("build-probe-take") == len(left)
    assert op.Timers().sum_ns("partition") > 0


def test_join_gpu_wide_payloads_on_the_shuffle_join_match_join_tpu():
    # u64 / f64 / f32 payloads ride the shuffle join as u32 planes
    from dpu_olap_tpu import columnar as jcol
    from dpu_olap_tpu.operators.join_op import _recombine_u64 as jax_recombine_u64
    from dpu_olap_tpu_torch.operators.join_op import _recombine_u64

    cols_l, cols_r = _fallback_tables("wide_permuted", 2)
    jleft = jcol.Table([jcol.Batch.from_numpy(c) for c in cols_l])
    jright = jcol.Table([jcol.Batch.from_numpy(c) for c in cols_r])
    left, right = Table.from_reference(jleft), Table.from_reference(jright)
    op = JoinGpu(CPU_SET, left, right).Prepare()
    jop = JoinTpu(JaxDeviceSet.allocate(1), jleft, jright).Prepare()
    assert op._l_u64 and op._r_u64  # the wide columns were split
    out = _recombine_u64(op._run_ici(rounds=2), {**op._l_u64, **op._r_u64})
    jout = jax_recombine_u64(jop._run_ici(rounds=2), {**jop._l_u64, **jop._r_u64})
    names = list(cols_l[0]) + [c for c in cols_r[0] if c != "pk"]
    assert list(out) == list(jout) == names
    for n in names:
        assert out[n].dtype == jout[n].dtype
    np.testing.assert_array_equal(_bits(out, names), _bits(jout, names))
    nat = JoinNative(left, right).Prepare().Run()
    np.testing.assert_array_equal(
        _bits(out, names), _bits({n: nat[n].to_numpy() for n in names}, names)
    )


@pytest.mark.parametrize("rows, impl", [
    ((512, 256), "cosort"),   # one round fits: the single-round join
    ((512, 256), "sort"),     # another impl: the shuffle join
    ((512, 256), "cuckoo"),
    ((2048, 256), "cosort"),  # above SINGLE_ROUND_ROWS: resident rounds
    ((4096, 256), "cosort"),  # above MAX_RESIDENT_ROWS: host-staged
    ((4096, 4096), "sort"),
])
def test_join_gpu_routes_like_join_tpu(rows, impl):
    from dpu_olap_tpu.columnar import Batch as JaxBatch
    from dpu_olap_tpu.columnar import Table as JaxTable

    bl, br = rows
    jleft = JaxTable([JaxBatch.from_numpy({"fk": np.zeros(bl, np.uint32), "y": np.zeros(bl, np.uint32)})])
    jright = JaxTable([JaxBatch.from_numpy({"pk": np.arange(br, dtype=np.uint32),
                                            "x": np.zeros(br, np.uint32)})])
    op = JoinGpu(CPU_SET, Table.from_reference(jleft), Table.from_reference(jright), impl=impl).Prepare()
    jop = JoinTpu(JaxDeviceSet.allocate(1), jleft, jright, impl=impl).Prepare()
    picked = []
    for o in (op, jop):
        o.SINGLE_ROUND_ROWS, o.MAX_RESIDENT_ROWS = 1024, 2048
        o._run_single = lambda: picked.append("single")
        o._run_ici = lambda: picked.append("ici")
        o._run_partitioned = lambda: picked.append("partitioned")
        o._run_any()
    assert picked[0] == picked[1]
    assert op._ici_rounds() == jop._ici_rounds() == -(-max(rows) // 1024)
