"""Parity of the port's sorted-store hash table (dpu_olap_tpu_torch.ops.
hashtable: ht_build_sorted, ht_probe_sorted, ht_probe_sorted_stream, CPU
paths) with the JAX package's, its Pallas sort and merge-probe run in
interpret mode, on tests/test_hashtable.py:95-230's cases. Integer data:
exact equality; the order-free stream is compared as a set keyed on pos."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops import hashtable as jht
from dpu_olap_tpu_torch.ops import hashtable, merge_cuda, sort_cuda
from dpu_olap_tpu_torch.ops.hashtable import (
    EMPTY,
    SortedTable,
    ht_build_sorted,
    ht_probe_sorted,
    ht_probe_sorted_stream,
)


def _oracle(keys, vals, queries):
    lut = dict(zip(keys.tolist(), vals.tolist()))
    exp_found = np.asarray([int(x) != EMPTY and int(x) in lut for x in queries])
    exp_val = np.asarray([lut.get(int(x), 0) if f else 0 for x, f in zip(queries, exp_found)],
                         np.uint32)
    return exp_val, exp_found


def _tables(keys, vals, valid=None):
    t = torch.from_numpy
    table = ht_build_sorted(t(keys), t(vals), None if valid is None else t(valid))
    jtable = jht.ht_build_sorted(jnp.asarray(keys), jnp.asarray(vals),
                                 None if valid is None else jnp.asarray(valid), interpret=True)
    assert isinstance(table, SortedTable) and table.keys.dtype == torch.uint32
    np.testing.assert_array_equal(table.keys.numpy(), np.asarray(jtable.keys))
    live = table.keys.numpy() != EMPTY
    np.testing.assert_array_equal(table.values.numpy()[live], np.asarray(jtable.values)[live])
    # the EMPTY tail's values: the same multiset (the sorts may permute ties)
    np.testing.assert_array_equal(np.sort(table.values.numpy()[~live]),
                                  np.sort(np.asarray(jtable.values)[~live]))
    assert table.stats() == jtable.stats()
    return table, jtable


def _probe(table, jtable, queries):
    got, found = ht_probe_sorted(table, torch.from_numpy(queries))
    jgot, jfound = jht.ht_probe_sorted(jtable, jnp.asarray(queries), interpret=True)
    assert got.dtype == torch.uint32 and found.dtype == torch.bool
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    return got.numpy(), found.numpy()


def _build(rng, n):
    keys = rng.choice(np.uint32(2**32 - 2), size=n, replace=False).astype(np.uint32)
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    return keys, vals, *_tables(keys, vals)


def test_sorted_build_and_probe_all_present_match_jax(rng):
    keys, vals, table, jtable = _build(rng, 1 << 14)
    got, found = _probe(table, jtable, keys)
    assert found.all()
    np.testing.assert_array_equal(got, vals)


def test_sorted_probe_hit_miss_mix_matches_jax(rng):
    keys, vals, table, jtable = _build(rng, 1 << 14)
    queries = np.concatenate([keys[rng.integers(0, keys.size, 1 << 13)],
                              rng.integers(0, 2**32 - 2, size=1 << 13, dtype=np.uint32)])
    rng.shuffle(queries)
    got, found = _probe(table, jtable, queries)
    exp_val, exp_found = _oracle(keys, vals, queries)
    np.testing.assert_array_equal(found, exp_found)
    np.testing.assert_array_equal(got, exp_val)


def test_sorted_valid_mask_and_sentinel_match_jax(rng):
    n = 1 << 10
    keys = rng.choice(np.uint32(2**31), size=n, replace=False).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    valid = np.zeros(n, bool)
    valid[: n // 2] = True
    table, jtable = _tables(keys, vals, valid)
    assert table.stats()["occupied"] == n // 2
    assert _probe(table, jtable, keys[: n // 2])[1].all()
    assert not _probe(table, jtable, keys[n // 2:])[1].any()
    for q in ([EMPTY], [EMPTY, keys[0]], []):  # k = 1, 2 and 0 queries
        got, found = _probe(table, jtable, np.asarray(q, np.uint32))
        np.testing.assert_array_equal(found, [False, True][: len(q)])


def test_sorted_duplicate_queries_match_jax(rng):
    keys, vals, table, jtable = _build(rng, 1 << 12)
    got, found = _probe(table, jtable, np.repeat(keys[:64], 37))
    assert found.all()
    np.testing.assert_array_equal(got, np.repeat(vals[:64], 37))


def _empty_query_case(rng):
    n, k = 16 << 10, 9_001
    keys = rng.permutation(np.uint32(4 * n))[:n].astype(np.uint32)
    vals = keys ^ np.uint32(0xA5A5A5A5)
    q = rng.integers(0, 4 * n, k, dtype=np.uint32)
    q[rng.choice(k, 100, replace=False)] = EMPTY
    return keys, vals, q


def test_probe_sorted_empty_queries_nonpow2_matches_jax(rng):
    keys, vals, q = _empty_query_case(rng)
    table, jtable = _tables(keys, vals)
    got, found = _probe(table, jtable, q)
    exp_val, exp_found = _oracle(keys, vals, q)
    np.testing.assert_array_equal(found, exp_found)
    np.testing.assert_array_equal(got, exp_val)


def _scatter_stream(pos, got, found, k):
    real = pos < k
    assert real.sum() == k and not found[~real].any()
    assert np.array_equal(np.sort(pos[real]), np.arange(k))
    oval, ofound = np.zeros(k, np.uint32), np.zeros(k, bool)
    oval[pos[real]], ofound[pos[real]] = got[real], found[real]
    return oval, ofound


@pytest.mark.parametrize("case", ["pow2", "nonpow2_empty"])
def test_probe_sorted_stream_matches_jax_as_a_set(rng, case):
    if case == "pow2":
        keys, vals, table, jtable = _build(rng, 1 << 14)
        q = np.concatenate([keys[rng.integers(0, keys.size, 1 << 13)],
                            rng.integers(0, 2**32 - 2, size=1 << 13, dtype=np.uint32)])
        rng.shuffle(q)
    else:
        keys, vals, q = _empty_query_case(rng)
        table, jtable = _tables(keys, vals)
    k = q.size
    pos, got, found = (t.numpy() for t in ht_probe_sorted_stream(table, torch.from_numpy(q)))
    jpos, jgot, jfound = (np.asarray(a) for a in
                          jht.ht_probe_sorted_stream(jtable, jnp.asarray(q), interpret=True))
    npow = 1 << (k - 1).bit_length()
    assert pos.shape == got.shape == found.shape == jpos.shape == (npow,)
    assert pos.dtype == np.uint32
    oval, ofound = _scatter_stream(pos, got, found, k)
    joval, jofound = _scatter_stream(jpos, jgot, jfound, k)
    np.testing.assert_array_equal(ofound, jofound)
    np.testing.assert_array_equal(oval, joval)
    exp_val, exp_found = _oracle(keys, vals, q)
    np.testing.assert_array_equal(ofound, exp_found)
    np.testing.assert_array_equal(oval, exp_val)


def test_sorted_table_small_and_empty():
    t = torch.from_numpy
    table = ht_build_sorted(t(np.array([7], np.uint32)), t(np.array([70], np.uint32)))
    assert table.stats() == {"capacity": 1, "occupied": 1, "load_factor": 1.0,
                             "build_rounds": 1, "converged": True}
    got, found = ht_probe_sorted(table, t(np.array([7, 6, 8, 7], np.uint32)))
    assert found.tolist() == [True, False, False, True] and got.tolist() == [70, 0, 0, 70]
    pos, got, found = ht_probe_sorted_stream(table, t(np.array([7], np.uint32)))
    assert pos.tolist() == [0] and got.tolist() == [70] and found.tolist() == [True]
    empty = ht_build_sorted(t(np.zeros(0, np.uint32)), t(np.zeros(0, np.uint32)))
    assert empty.stats()["load_factor"] == 0.0
    got, found = ht_probe_sorted(empty, t(np.array([1, 2, 3], np.uint32)))
    assert not found.any() and not got.numpy().any()


def test_sorted_probe_cpu_path_launches_nothing(rng):
    keys, vals, table, _ = _build(rng, 1 << 10)
    before = (sort_cuda.LAUNCHES, merge_cuda.LAUNCHES)
    ht_probe_sorted(table, torch.from_numpy(keys))
    ht_probe_sorted_stream(table, torch.from_numpy(keys))
    assert (sort_cuda.LAUNCHES, merge_cuda.LAUNCHES) == before
    assert hashtable._signed_view(torch.tensor([0, 0x80000000], dtype=torch.int64)
                                  .to(torch.uint32)).tolist() == [-2**31, 0]
