"""Parity of the port's one-device shuffle and shuffle join
(dpu_olap_tpu_torch.parallel.shuffle and parallel.dist_join, CPU paths)
with the JAX package on a one-device mesh and with pyarrow, on
tests/test_shuffle.py's and tests/test_dist_join.py's shapes at d = 1.
Integer data: exact equality; the co-sort join's rows after a canonical
sort (its sorts permute the payloads of equal keys)."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dpu_olap_tpu.generator import make_join_tables as jax_make_join_tables
from dpu_olap_tpu.parallel import shuffle as jshuffle
from dpu_olap_tpu.parallel.dist_join import dist_join as jax_dist_join
from dpu_olap_tpu.parallel.mesh import AXIS
from dpu_olap_tpu.parallel.mesh import DeviceSet as JaxDeviceSet
from dpu_olap_tpu_torch.parallel.dist_join import dist_join
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet
from dpu_olap_tpu_torch.parallel.shuffle import (
    default_cell_size,
    local_fragments,
    shuffle_partitions,
)

CPU_SET = DeviceSet(torch.device("cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _canon(cols):
    rows = np.stack([np.asarray(c) for c in cols])
    return rows[:, np.lexsort(rows[::-1])]


@pytest.mark.parametrize("p, cell, overflow", [
    (8, 512, False), (8, 128, True), (32, 128, False), (1, 2048, False),  # JAX tests' cases
    (2, 1024, False), (16, 256, False), (3, 1024, False), (64, 128, False),  # either side of the gate
])
def test_local_fragments_matches_jax(rng, p, cell, overflow):
    """Kernel-gated P (a power of two in [2, 16]) and the others take the
    same plain partition on the CPU: bit for bit with the JAX shuffle."""
    keys = rng.integers(0, 2**32, size=1024, dtype=np.uint32)
    pay = rng.integers(0, 2**32, size=1024, dtype=np.uint32)
    ck, (cp,), counts, ovf = local_fragments(_t(keys), (_t(pay),), p, cell)
    jck, (jcp,), jcounts, jovf = jshuffle.local_fragments(jnp.asarray(keys), (jnp.asarray(pay),), p, cell)
    np.testing.assert_array_equal(ck.numpy(), np.asarray(jck))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(jcp))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert bool(ovf) == bool(jovf) == overflow


def _jax_shuffle(keys, pay, cell, rounds):
    ds = JaxDeviceSet.allocate(1)
    fn = ds.shard_fn(
        lambda k, q: jshuffle.shuffle_partitions(k, (q,), 1, cell, rounds=rounds),
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=P(AXIS),
    )
    return fn(ds.scatter(keys), ds.scatter(pay))


@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_shuffle_partitions_matches_jax(rng, rounds):
    n = 2048
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    pay = np.arange(n, dtype=np.uint32)  # row id as payload
    cell = default_cell_size(n, rounds, 2.0)
    assert cell == jshuffle.default_cell_size(n, rounds, 2.0)
    res = shuffle_partitions(_t(keys), (_t(pay),), 1, cell, rounds=rounds)
    jres = _jax_shuffle(keys, pay, cell, rounds)
    assert res.rounds == rounds and res.overflow.shape == (1,) and not bool(res.overflow.any())
    np.testing.assert_array_equal(res.keys.numpy(), np.asarray(jres.keys))
    np.testing.assert_array_equal(res.payloads[0].numpy(), np.asarray(jres.payloads[0]))
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    for got, want in ((res.flat(), jres.flat()), (res.round_planes(), jres.round_planes())):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1][0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert res.round_planes()[0].shape == (rounds, cell)
    assert int(res.counts.to(torch.int64).sum()) == n


def test_shuffle_more_than_one_device_raises(rng):
    """Once a raise (the exchange was not ported): two devices' shards now
    shuffle and join as the JAX package's two-device mesh does, block for
    block (tests/test_torch_multidevice.py covers d = 2, 4 and 8)."""
    import jax

    n = 512
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    ds = DeviceSet([torch.device("cpu")] * 2)
    jds = JaxDeviceSet(jax.devices()[:2])
    res = shuffle_partitions(ds.split(keys), (ds.split(pay),), 2, 256)
    jres = jds.shard_fn(lambda k, q: jshuffle.shuffle_partitions(k, (q,), 2, 256),
                        in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS))(
        jds.scatter(keys), jds.scatter(pay))
    for got, want in ((np.concatenate([r.keys.numpy() for r in res]), jres.keys),
                      (np.concatenate([r.payloads[0].numpy() for r in res]), jres.payloads[0]),
                      (np.concatenate([r.counts.numpy() for r in res]), jres.counts)):
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="tuple of shards"):
        shuffle_partitions(_t(keys), (), 2, 256)
    fk, _, _, matched, overflow = dist_join(ds, keys, (), keys, ())
    jfk, _, _, jm, _ = jax_dist_join(jds, jnp.asarray(keys), (), jnp.asarray(keys), ())
    assert len(fk) == 2 and not any(bool(o.any()) for o in overflow)
    np.testing.assert_array_equal(np.concatenate([m.numpy() for m in matched]), np.asarray(jm))
    np.testing.assert_array_equal(np.concatenate([f.numpy() for f in fk]), np.asarray(jfk))


def test_default_cell_size_matches_jax():
    for rows, p, slack in [(2048, 8, 2.0), (100, 8, 1.5), (1, 8, 1.0), (1 << 27, 2, 2.0)]:
        assert default_cell_size(rows, p, slack) == jshuffle.default_cell_size(rows, p, slack)


def _rows(res):
    fk, (y,), (x,), matched = (np.asarray(res[0]), tuple(np.asarray(c) for c in res[1]),
                               tuple(np.asarray(c) for c in res[2]), np.asarray(res[3]))
    return fk, y, x, matched


@pytest.mark.parametrize("impl", ["cosort", "sort", "cuckoo"])
@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_dist_join_matches_jax_and_arrow(impl, rounds):
    left, right = jax_make_join_tables(8, 1 << 11, 1 << 10)
    lf, rt = left.concat(), right.concat()
    args = (lf["fk"], (lf["y"],), rt["pk"], (rt["x"],))
    res = dist_join(CPU_SET, np.asarray(lf["fk"]), (np.asarray(lf["y"]),),
                    np.asarray(rt["pk"]), (np.asarray(rt["x"]),), impl=impl, rounds=rounds)
    jres = jax_dist_join(JaxDeviceSet.allocate(1), *args, impl=impl, rounds=rounds)
    assert not bool(res[4].any()) and not np.any(np.asarray(jres[4]))
    fk, y, x, m = _rows(res[:4])
    jfk, jy, jx, jm = _rows(jres[:4])
    assert res[0].dtype == torch.uint32 and len(fk) == len(jfk)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(fk, jfk)
    if impl == "cosort":  # key-sorted rows: equal keys may permute payloads
        np.testing.assert_array_equal(_canon([fk, y, x]), _canon([jfk, jy, jx]))
    else:  # one row per left row, in each round's left order
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(x, jx)
    assert m.sum() == 8 << 11  # guaranteed-match inner join: every left row
    expect = pa.Table.from_batches([b.to_arrow() for b in left]).join(
        pa.Table.from_batches([b.to_arrow() for b in right]),
        keys="fk", right_keys="pk", join_type="inner",
    )
    np.testing.assert_array_equal(
        _canon([fk[m], y[m], x[m]]), _canon([expect[c].to_numpy() for c in ("fk", "y", "x")])
    )


@pytest.mark.parametrize("rounds", [1, 2])
def test_dist_join_skewed_keys_matches_jax(rng, rounds):
    # 50% of fks hit 1% of the pk space (tests/test_dist_join.py:48-76 at d = 1)
    n = 8 * 1024
    pk = np.arange(n, dtype=np.uint32)
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    hot = rng.integers(0, n // 100, size=n // 2).astype(np.uint32)
    cold = rng.integers(0, n, size=n - n // 2).astype(np.uint32)
    fk = np.concatenate([hot, cold]).astype(np.uint32)
    rng.shuffle(fk)
    y = np.arange(n, dtype=np.uint32)
    cell = 2 * n // rounds  # hot-key fragments can approach the whole side
    res = dist_join(CPU_SET, fk, (y,), pk, (x,), cell_left=cell, rounds=rounds)
    jres = jax_dist_join(JaxDeviceSet.allocate(1), jnp.asarray(fk), (jnp.asarray(y),),
                         jnp.asarray(pk), (jnp.asarray(x),), cell_left=cell, rounds=rounds)
    assert not bool(res[4].any()) and not np.any(np.asarray(jres[4]))
    fko, yo, xo, m = _rows(res[:4])
    jfk, jy, jx, jm = _rows(jres[:4])
    np.testing.assert_array_equal(m, jm)
    assert m.sum() == n
    np.testing.assert_array_equal(xo[m], x[fko[m]])
    np.testing.assert_array_equal(_canon([fko[m], yo[m], xo[m]]), _canon([jfk[jm], jy[jm], jx[jm]]))


def test_dist_join_reports_overflow(rng):
    n = 4096
    pk = np.arange(n, dtype=np.uint32)
    fk = np.zeros(n, np.uint32)  # one key: one bucket holds every left row
    res = dist_join(CPU_SET, fk, (pk,), pk, (pk,), cell_left=1024, rounds=2)
    jres = jax_dist_join(JaxDeviceSet.allocate(1), jnp.asarray(fk), (jnp.asarray(pk),),
                         jnp.asarray(pk), (jnp.asarray(pk),), cell_left=1024, rounds=2)
    assert bool(res[4].any()) and bool(np.any(np.asarray(jres[4])))
