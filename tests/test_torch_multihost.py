"""The port's two-level mesh and hierarchical shuffle
(dpu_olap_tpu_torch.parallel.multihost) on DeviceSets of CPU devices, twin
of tests/test_multihost.py: on 2 x 2 and 2 x 4 meshes the hierarchical
shuffle equals the flat one bit for bit, device by device, and the
hierarchical join equals the flat join, the JAX package's dist_join_2d on
its virtual mesh and pyarrow, rows after a canonical sort."""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.sharding import Mesh

from dpu_olap_tpu.generator import make_join_tables as jax_make_join_tables
from dpu_olap_tpu.parallel.multihost import DCN_AXIS, ICI_AXIS
from dpu_olap_tpu.parallel.multihost import dist_join_2d as jax_dist_join_2d
from dpu_olap_tpu_torch.metrics import counts
from dpu_olap_tpu_torch.parallel import shuffle
from dpu_olap_tpu_torch.parallel.dist_join import dist_join
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet
from dpu_olap_tpu_torch.parallel.multihost import (
    dist_join_2d,
    make_mesh_2d,
    shuffle_partitions_2d,
)

MESHES = [(2, 2), (2, 4)]


def cpu_set(d):
    return DeviceSet([torch.device("cpu")] * d)


def canon(cols):
    rows = np.stack([np.asarray(c) for c in cols])
    return rows[:, np.lexsort(rows[::-1])]


def blocks(shards):
    return np.concatenate([s.numpy() for s in shards])


@pytest.fixture(scope="module")
def tables():
    left, right = jax_make_join_tables(8, 1 << 11, 1 << 10)
    lf, rt = left.concat(), right.concat()
    return left, right, [np.asarray(lf[c]) for c in ("fk", "y")], \
        [np.asarray(rt[c]) for c in ("pk", "x")]


def test_mesh_axes():
    mesh = make_mesh_2d(n_hosts=2, chips_per_host=4, ds=cpu_set(8))
    assert mesh.shape["dcn"] == 2 and mesh.shape["ici"] == 4
    assert make_mesh_2d(ds=cpu_set(8)).shape == {"dcn": 2, "ici": 4}
    assert make_mesh_2d(2, 2, ds=cpu_set(8)).ds.nr_devices == 4
    with pytest.raises(ValueError, match="not divisible into 2 hosts"):
        make_mesh_2d(ds=cpu_set(3))


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("h, c", MESHES)
def test_hierarchical_shuffle_equals_flat(h, c, rounds):
    d = h * c
    rng = np.random.default_rng(d + rounds)
    n = d * 1024
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    cell = shuffle.default_cell_size(n // d, d * rounds, 2.0)
    ds = cpu_set(d)
    flat = shuffle.shuffle_partitions(ds.split(keys), (ds.split(pay),), d, cell, rounds=rounds)
    copies = counts()["exchange.copies"]
    two = shuffle_partitions_2d(ds.split(keys), (ds.split(pay),), h, c, cell, rounds=rounds)
    # two stages, each a cat a destination, for the planes and the counts
    assert counts()["exchange.copies"] - copies == 2 * 2 * d
    for a, b in zip(flat, two):
        assert torch.equal(a.keys, b.keys) and torch.equal(a.payloads[0], b.payloads[0])
        assert torch.equal(a.counts, b.counts) and torch.equal(a.overflow, b.overflow)
        assert a.rounds == b.rounds == rounds


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("h, c", MESHES)
def test_dist_join_2d_matches_flat_jax_and_arrow(tables, h, c, rounds):
    d = h * c
    left, right, (lfk, ly), (rpk, rx) = tables
    mesh = make_mesh_2d(h, c, ds=cpu_set(d))
    fk, (y,), (x,), matched, overflow = dist_join_2d(mesh, lfk, (ly,), rpk, (rx,), rounds=rounds)
    assert len(fk) == d and not blocks(overflow).any()
    m = blocks(matched)
    got = [blocks(fk)[m], blocks(y)[m], blocks(x)[m]]
    assert m.sum() == len(lfk)
    # the flat join on the same devices: the same rows, device by device
    ffk, (fy,), (fx,), fm, _ = dist_join(cpu_set(d), lfk, (ly,), rpk, (rx,), rounds=rounds)
    np.testing.assert_array_equal(blocks(fm), m)
    np.testing.assert_array_equal(blocks(ffk), blocks(fk))
    np.testing.assert_array_equal(canon(got), canon([blocks(ffk)[m], blocks(fy)[m],
                                                     blocks(fx)[m]]))
    # the JAX package's hierarchical join on its virtual h x c mesh
    jmesh = Mesh(np.array(jax.devices()[:d]).reshape(h, c), (DCN_AXIS, ICI_AXIS))
    jfk, (jy,), (jx,), jm, jovf = jax_dist_join_2d(
        jmesh, jnp.asarray(lfk), (jnp.asarray(ly),), jnp.asarray(rpk), (jnp.asarray(rx),),
        rounds=rounds)
    jm = np.asarray(jm)
    assert not np.asarray(jovf).any()
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(blocks(fk), np.asarray(jfk))
    np.testing.assert_array_equal(
        canon(got), canon([np.asarray(jfk)[jm], np.asarray(jy)[jm], np.asarray(jx)[jm]]))
    expect = pa.Table.from_batches([b.to_arrow() for b in left]).join(
        pa.Table.from_batches([b.to_arrow() for b in right]),
        keys="fk", right_keys="pk", join_type="inner")
    np.testing.assert_array_equal(canon(got),
                                  canon([expect[c].to_numpy() for c in ("fk", "y", "x")]))
