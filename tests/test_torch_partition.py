"""Parity of the port's radix partition (dpu_olap_tpu_torch.ops.hashing,
ops.partition and ops.partition_cuda, CPU paths) with the JAX package: the
bucket mapping, radix_partition, the Pallas cells kernel in interpret mode
and the JAX shuffle's XLA cell layout. Integer data: exact equality
throughout; against the Pallas kernel only the rows [:count], the counts
and the flag compare (its padded lanes are unspecified,
dpu_olap_tpu/parallel/shuffle.py:112-113)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops import hashing as jhash
from dpu_olap_tpu.ops.partition import radix_partition as jax_radix_partition
from dpu_olap_tpu.ops.partition import (
    radix_partition_with_payload as jax_radix_partition_with_payload,
)
from dpu_olap_tpu.ops.partition_pallas import partition_cells_pallas
from dpu_olap_tpu.parallel.shuffle import local_fragments as jax_local_fragments
from dpu_olap_tpu_torch.ops import hashing, partition_cuda
from dpu_olap_tpu_torch.ops.partition import radix_partition, radix_partition_with_payload
from dpu_olap_tpu_torch.ops.partition_cuda import partition_cells, partition_cells_ref

BLK = 256 * 128  # the Pallas kernel's block: n must be a multiple of it
EDGE_KEYS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _keys(rng, n):
    k = rng.integers(0, 2**32, n, dtype=np.uint32)
    k[: len(EDGE_KEYS)] = EDGE_KEYS
    return k


def test_wang_hash_np_and_bucket_shift_match_jax(rng):
    k = _keys(rng, 4096)
    np.testing.assert_array_equal(hashing.wang_hash_np(k), jhash.wang_hash_np(k))
    np.testing.assert_array_equal(
        hashing.wang_hash(torch.from_numpy(k)).numpy(), np.asarray(jhash.wang_hash(jnp.asarray(k)))
    )
    for p in (1, 2, 3, 8, 16, 17, 32, 1 << 20):
        assert hashing.bucket_shift(p) == jhash.bucket_shift(p)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8, 16, 17, 32, 64, 1 << 10, 1 << 20])
def test_radix_bucket_matches_jax(rng, p):
    k = _keys(rng, 4096)
    got = hashing.radix_bucket(torch.from_numpy(k), p)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhash.radix_bucket(jnp.asarray(k), p)))


@pytest.mark.parametrize("p", [1, 2, 8, 16, 32])
def test_radix_partition_matches_jax(rng, p):
    k = _keys(rng, 1 << 14)
    pay = rng.integers(0, 2**32, k.size, dtype=np.uint32)
    res, (moved,) = radix_partition_with_payload(torch.from_numpy(k), (torch.from_numpy(pay),), p)
    jres, (jmoved,) = jax_radix_partition_with_payload(jnp.asarray(k), (jnp.asarray(pay),), p)
    for name in ("keys", "selection_indices", "counts", "offsets"):
        got = getattr(res, name)
        assert got.dtype == torch.uint32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jres, name)), err_msg=name)
    np.testing.assert_array_equal(moved.numpy(), np.asarray(jmoved))
    alone = radix_partition(torch.from_numpy(k), p)
    np.testing.assert_array_equal(alone.keys.numpy(), np.asarray(jax_radix_partition(jnp.asarray(k), p).keys))


def _check_against_pallas(keys, pays, p, cell, overflow=False):
    t = torch.from_numpy
    ck, cp, cs, counts, ovf = partition_cells_ref(t(keys), tuple(map(t, pays)), p, cell)
    jck, jcp, jcs, jcounts, jovf = partition_cells_pallas(
        jnp.asarray(keys), tuple(map(jnp.asarray, pays)), p, cell, interpret=True
    )
    assert bool(ovf) == bool(jovf) == overflow
    assert ck.shape == cs.shape == (p, cell) and len(cp) == len(pays)
    if overflow:  # the Pallas counts are clamped running offsets there
        return ck, cp, cs, counts
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    jck, jcs = np.asarray(jck), np.asarray(jcs)
    for q in range(p):
        c = int(counts[q])
        np.testing.assert_array_equal(ck[q, :c].numpy(), jck[q, :c])
        np.testing.assert_array_equal(cs[q, :c].numpy(), jcs[q, :c])
        for a, b in zip(cp, jcp):
            np.testing.assert_array_equal(a[q, :c].numpy(), np.asarray(b)[q, :c])
    return ck, cp, cs, counts


def _check_pads(ck, cp, cs, counts):
    cell = ck.shape[1]
    pad = np.arange(cell)[None, :] >= counts.numpy().astype(np.int64)[:, None]
    assert np.all(ck.numpy()[pad] == 0xFFFFFFFF) and np.all(cs.numpy()[pad] == 0xFFFFFFFF)
    assert all(not c.numpy()[pad].any() for c in cp)


@pytest.mark.parametrize("p", [2, 8, 16])
def test_partition_cells_ref_matches_pallas(rng, p):
    k = _keys(rng, BLK)
    pay = rng.integers(0, 2**32, BLK, dtype=np.uint32)
    _check_pads(*_check_against_pallas(k, [pay], p, (BLK // p) * 4))


def test_partition_cells_ref_multiblock_matches_pallas(rng):
    n = 2 * BLK
    k = _keys(rng, n)
    _check_against_pallas(k, [np.arange(n, dtype=np.uint32)], 8, (n // 8) * 2)


def test_partition_cells_ref_skewed_single_bucket_matches_pallas(rng):
    n = BLK
    k = np.full(n, rng.integers(0, 2**32, dtype=np.uint32), dtype=np.uint32)
    ck, cp, cs, counts = _check_against_pallas(k, [np.arange(n, dtype=np.uint32)], 8, n + 128)
    assert int(counts.numpy().max()) == n
    _check_pads(ck, cp, cs, counts)


def test_partition_cells_ref_overflow_flag_and_true_counts(rng):
    n = BLK
    k = np.zeros(n, dtype=np.uint32)  # one bucket
    ck, cp, cs, counts = _check_against_pallas(k, [np.zeros(n, np.uint32)], 8, 1024, overflow=True)
    b = int(hashing.wang_hash_np(np.zeros(1, np.uint32))[0] >> np.uint32(hashing.bucket_shift(8)))
    assert int(counts[b]) == n and int(counts.sum()) == n  # the true histogram
    np.testing.assert_array_equal(cs[b].numpy(), np.arange(1024))  # its first cell rows


def test_partition_cells_ref_no_payload_matches_pallas(rng):
    ck, cp, cs, counts = _check_against_pallas(_keys(rng, BLK), [], 4, (BLK // 4) * 2)
    assert cp == ()
    _check_pads(ck, cp, cs, counts)


@pytest.mark.parametrize("p, n, cell, n_pay", [
    (2, 1000, 512, 1),
    (8, 1 << 12, 1 << 10, 3),
    (16, 3 * 1024 + 17, 384, 0),
    (8, 4096, 128, 2),  # overflow
])
def test_partition_cells_ref_matches_jax_local_fragments(rng, p, n, cell, n_pay):
    """Bit for bit with the JAX shuffle's XLA path, padded lanes included."""
    k = _keys(rng, n)
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
    ck, cp, _cs, counts, ovf = partition_cells(
        torch.from_numpy(k), tuple(map(torch.from_numpy, pays)), p, cell, with_sel=False
    )
    assert _cs is None
    jck, jcp, jcounts, jovf = jax_local_fragments(jnp.asarray(k), tuple(map(jnp.asarray, pays)), p, cell)
    np.testing.assert_array_equal(ck.numpy(), np.asarray(jck))
    for a, b in zip(cp, jcp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert bool(ovf) == bool(jovf)


def test_partition_cells_empty_and_rejects_bad_input():
    ck, cp, cs, counts, ovf = partition_cells(
        torch.zeros(0, dtype=torch.uint32), (torch.zeros(0, dtype=torch.uint32),), 4, 8
    )
    assert not bool(ovf) and not counts.numpy().any()
    _check_pads(ck, cp, cs, counts)
    k = torch.zeros(4, dtype=torch.uint32)
    for bad, match in [
        (lambda: partition_cells(k, (), 3, 8), "power of two"),
        (lambda: partition_cells(k, (), 32, 8), "power of two"),
        (lambda: partition_cells(k, (), 4, 0), "cell_size"),
        (lambda: partition_cells(k.view(torch.int32), (), 4, 8), "uint32"),
        (lambda: partition_cells(k, (torch.zeros(3, dtype=torch.uint32),), 4, 8), "length"),
        (lambda: partition_cells(torch.zeros(4, dtype=torch.uint32, device="meta"), (), 4, 8),
         "cuda or cpu"),
    ]:
        with pytest.raises(ValueError, match=match):
            bad()
    before = partition_cuda.LAUNCHES
    partition_cells(k, (k,), 4, 8)
    assert partition_cuda.LAUNCHES == before  # the CPU path launches nothing

