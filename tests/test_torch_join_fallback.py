"""Parity of the port's join fallbacks (dpu_olap_tpu_torch.ops.join,
merge.join_shard_sorted_build, hashtable) with the JAX package's
ops/join.py, merge_xla.join_shard_sorted_build and ops/hashtable.py on the
CPU, on the same numpy inputs (the cases of tests/test_join.py). Integer
data: exact comparison; rows after a canonical sort where ties may order
payloads differently. JAX's sorted-build join runs its merge outside
interpret mode, which the CPU backend refuses from a 64Ki merge on, so its
parity cases keep n_l + n_r <= 32Ki (larger merges are held against
merge_xla.bitonic_merge(interpret=True) in test_torch_bitonic.py)."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from dpu_olap_tpu.generator import make_join_tables as jax_make_join_tables
from dpu_olap_tpu.ops import hashtable as jht
from dpu_olap_tpu.ops import join as jjoin
from dpu_olap_tpu.ops.hashing import wang_hash_np
from dpu_olap_tpu.ops.merge_xla import join_shard_sorted_build as jax_sorted_build
from dpu_olap_tpu_torch.ops import hashtable, join
from dpu_olap_tpu_torch.ops.hashing import wang_hash
from dpu_olap_tpu_torch.ops.merge import join_shard_sorted_build

IMPLS = ["cuckoo", "sort", "cosort"]


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _canon(key, lcols, rcols, matched):
    m = np.asarray(matched)
    rows = np.stack([np.asarray(key)[m], *(np.asarray(c)[m] for c in (*lcols, *rcols))])
    return rows[:, np.lexsort(rows[::-1])]


def _np(res):
    key, lcols, rcols, m = res
    to = (lambda x: x.numpy()) if isinstance(key, torch.Tensor) else np.asarray
    return to(key), [to(c) for c in lcols], [to(c) for c in rcols], to(m)


def assert_padded_join_equal(got, ref):
    """Key-sorted padded results: the key and matched planes position by
    position, the rows after a canonical sort."""
    g, r = _np(got), _np(ref)
    assert g[0].dtype == np.uint32 and g[3].dtype == np.bool_
    np.testing.assert_array_equal(g[0], r[0])
    np.testing.assert_array_equal(g[3], r[3])
    np.testing.assert_array_equal(_canon(*g), _canon(*r))
    for c in (*g[1], *g[2]):  # unmatched rows are 0
        assert not c[~g[3]].any()


def _padding_case(rng):
    n_r, n_l = 1024, 2048
    pk = rng.choice(np.uint32(2**31), size=n_r, replace=False).astype(np.uint32)
    x = rng.integers(0, 2**32, size=n_r, dtype=np.uint32)
    r_valid = np.zeros(n_r, bool)
    r_valid[: n_r // 2] = True
    fk = pk[rng.integers(0, n_r // 2, size=n_l)]
    y = rng.integers(0, 2**32, size=n_l, dtype=np.uint32)
    l_valid = np.zeros(n_l, bool)
    l_valid[: n_l // 2] = True
    return fk, y, pk, x, l_valid, r_valid


def _misses_case(rng, top=0):
    n_r, n_l = 512, 768
    pk = rng.permutation(np.arange(2 * n_r, dtype=np.uint32))[:n_r] + np.uint32(top)
    fk = pk[rng.integers(0, n_r, n_l)]
    fk[:50] = np.uint32(top) + 2 * n_r + rng.integers(0, 100, 50).astype(np.uint32)
    x = rng.integers(0, 2**32, n_r, dtype=np.uint32)
    y = rng.integers(0, 2**32, n_l, dtype=np.uint32)
    return fk, y, pk, x


# ---- join_shard_fused --------------------------------------------------------

@pytest.mark.parametrize("keys31", [False, True])
def test_fused_generator_matches_jax_and_arrow(keys31):
    left, right = jax_make_join_tables(1, 1 << 13, 1 << 12)
    lb, rb = left[0], right[0]
    fk, y, pk, x = (np.asarray(a) for a in (lb["fk"], lb["y"], rb["pk"], rb["x"]))
    got = join.join_shard_fused(_t(fk), (_t(y),), _t(pk), (_t(x),), keys31=keys31)
    ref = jjoin.join_shard_fused(_j(fk), (_j(y),), _j(pk), (_j(x),), keys31=keys31)
    assert_padded_join_equal(got, ref)
    assert got[3].shape[0] == len(fk) + len(pk) and int(got[3].sum()) == len(fk)
    expect = pa.table({"fk": fk, "y": y}).join(
        pa.table({"pk": pk, "x": x}), keys="fk", right_keys="pk", join_type="inner")
    np.testing.assert_array_equal(
        _canon(*_np(got)), _canon(*(expect[c].to_numpy() for c in ("fk",)), [expect["y"].to_numpy()],
                                  [expect["x"].to_numpy()], np.ones(expect.num_rows, bool)))


@pytest.mark.parametrize("keys31", [False, True])
def test_fused_with_valid_masks_matches_jax(keys31):
    fk, y, pk, x, l_valid, r_valid = _padding_case(np.random.default_rng(42))
    got = join.join_shard_fused(_t(fk), (_t(y),), _t(pk), (_t(x),),
                                left_valid=_t(l_valid), right_valid=_t(r_valid), keys31=keys31)
    ref = jjoin.join_shard_fused(_j(fk), (_j(y),), _j(pk), (_j(x),),
                                 left_valid=_j(l_valid), right_valid=_j(r_valid), keys31=keys31)
    assert_padded_join_equal(got, ref)
    assert int(got[3].sum()) == len(fk) // 2  # only valid left rows match


@pytest.mark.parametrize("keys31", [False, True])
def test_fused_misses_and_payload_counts_match_jax(keys31):
    rng = np.random.default_rng(3)
    fk, y, pk, x = _misses_case(rng)
    x2 = rng.integers(-(2**31), 2**31, len(pk), dtype=np.int32)
    got = join.join_shard_fused(_t(fk), (_t(y),), _t(pk), (_t(x), _t(x2)), keys31=keys31)
    ref = jjoin.join_shard_fused(_j(fk), (_j(y),), _j(pk), (_j(x), _j(x2)), keys31=keys31)
    assert_padded_join_equal(got, ref)
    assert int(got[3].sum()) == len(fk) - 50


def test_fused_keys31_boundary_keys_match_jax():
    # keys just inside the packed range (0x7FFFFFFE) and EMPTY masking
    pk = np.asarray([0, 1, 0x7FFFFFFE, 1000], dtype=np.uint32)
    x = np.asarray([10, 11, 12, 13], dtype=np.uint32)
    fk = np.asarray([0x7FFFFFFE, 0, 5, 1000], dtype=np.uint32)
    y = np.asarray([20, 21, 22, 23], dtype=np.uint32)
    got = join.join_shard_fused(_t(fk), (_t(y),), _t(pk), (_t(x),), keys31=True)
    ref = jjoin.join_shard_fused(_j(fk), (_j(y),), _j(pk), (_j(x),), keys31=True)
    assert_padded_join_equal(got, ref)
    k, (yo,), (xo,), m = _np(got)
    assert sorted(zip(k[m].tolist(), yo[m].tolist(), xo[m].tolist())) == [
        (0, 21, 10), (1000, 23, 13), (0x7FFFFFFE, 20, 12)]


def test_fused_generic_keys_above_2_31_match_jax():
    fk, y, pk, x = _misses_case(np.random.default_rng(8), top=0x80000000)
    got = join.join_shard_fused(_t(fk), (_t(y),), _t(pk), (_t(x),))
    ref = jjoin.join_shard_fused(_j(fk), (_j(y),), _j(pk), (_j(x),))
    assert_padded_join_equal(got, ref)
    assert int(got[3].sum()) == len(fk) - 50


def test_fused_rejects_wide_payloads():
    u = torch.zeros(4, dtype=torch.uint32)
    with pytest.raises(TypeError, match="32-bit"):
        join.join_shard_fused(u, (u.to(torch.int64),), u, ())


# ---- join_shard_sorted_build / join_shard_auto -------------------------------

def _sorted_case(rng, n_r, n_l, n_x=1, n_y=1, sorted_pk=True):
    space = np.uint32(1 << 20)
    pk = rng.choice(space, n_r, replace=False).astype(np.uint32)
    if sorted_pk:
        pk = np.sort(pk)
    fk = pk[rng.integers(0, n_r, n_l)]
    miss = min(64, n_l // 4)
    fk[:miss] = space + rng.integers(0, 50, miss).astype(np.uint32)  # misses
    xs = [rng.integers(0, 2**32, n_r, dtype=np.uint32) for _ in range(n_x)]
    ys = [rng.integers(0, 2**32, n_l, dtype=np.uint32) for _ in range(n_y)]
    return fk, ys, pk, xs


@pytest.mark.parametrize("n_r, n_l, n_x, n_y, pk_sorted", [
    (1 << 11, 3 << 10, 1, 1, True),   # padded merge length non-trivial
    (1 << 10, 1 << 10, 1, 1, False),  # the build side sorted once
    (1 << 10, 1 << 11, 2, 1, True),   # more right payloads than left
    (100, 1 << 12, 0, 2, True),       # no right payload
    (3, 30, 1, 1, True),              # below the kernel's smallest merge
])
def test_sorted_build_matches_jax(n_r, n_l, n_x, n_y, pk_sorted):
    rng = np.random.default_rng(n_r + n_l)
    fk, ys, pk, xs = _sorted_case(rng, n_r, n_l, n_x, n_y, sorted_pk=pk_sorted)
    got = join_shard_sorted_build(_t(fk), tuple(map(_t, ys)), _t(pk), tuple(map(_t, xs)),
                                  pk_sorted=pk_sorted)
    ref = jax_sorted_build(_j(fk), tuple(map(_j, ys)), _j(pk), tuple(map(_j, xs)),
                           pk_sorted=pk_sorted)
    assert_padded_join_equal(got, ref)
    n = n_r + n_l
    assert got[0].shape[0] == 1 << (n - 1).bit_length()
    fused = join.join_shard_fused(_t(fk), tuple(map(_t, ys)), _t(pk), tuple(map(_t, xs)),
                                  keys31=True)
    np.testing.assert_array_equal(_canon(*_np(got)), _canon(*_np(fused)))


@pytest.mark.parametrize("keys31, pk_sorted", [(True, True), (True, False), (False, True)])
def test_join_shard_auto_matches_jax(keys31, pk_sorted):
    rng = np.random.default_rng(21)
    fk, ys, pk, xs = _sorted_case(rng, 1 << 10, 1 << 11, sorted_pk=pk_sorted)
    args_t = (_t(fk), tuple(map(_t, ys)), _t(pk), tuple(map(_t, xs)))
    args_j = (_j(fk), tuple(map(_j, ys)), _j(pk), tuple(map(_j, xs)))
    got = join.join_shard_auto(*args_t, keys31=keys31, pk_sorted=pk_sorted)
    ref = jjoin.join_shard_auto(*args_j, keys31=keys31, pk_sorted=pk_sorted)
    assert_padded_join_equal(got, ref)
    assert got[0].shape[0] == (4096 if keys31 and pk_sorted else 3 << 10)


# ---- probe_indices / join_shard (all three impls) ----------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_join_shard_literal(impl):
    pk = torch.tensor([10, 11, 12, 13], dtype=torch.uint32)
    x = torch.tensor([100, 110, 120, 130], dtype=torch.uint32)
    fk = torch.tensor([12, 10, 10, 13], dtype=torch.uint32)
    y = torch.tensor([7, 8, 9, 6], dtype=torch.uint32)
    fko, (yo,), (xo,), matched = join.join_shard(fk, (y,), pk, (x,), impl=impl)
    assert bool(matched.all())
    np.testing.assert_array_equal(xo.numpy(), [120, 100, 100, 130])
    np.testing.assert_array_equal(yo.numpy(), [7, 8, 9, 6])


@pytest.mark.parametrize("impl", IMPLS)
def test_probe_indices_matches_jax(impl):
    rng = np.random.default_rng(4)
    n = 4096
    pk = rng.permutation(np.arange(n, dtype=np.uint32))
    fk = pk[rng.integers(0, n, size=2 * n)]
    fk[:100] = n + rng.integers(0, 1000, 100).astype(np.uint32)  # misses
    sel, found = join.probe_indices(_t(fk), _t(pk), impl=impl)
    jsel, jfound = jjoin.probe_indices(_j(fk), _j(pk), impl=impl)
    found = found.numpy()
    np.testing.assert_array_equal(found, np.asarray(jfound))
    assert not found[:100].any() and found[100:].all()
    np.testing.assert_array_equal(sel.numpy()[found], np.asarray(jsel)[found])
    np.testing.assert_array_equal(pk[sel.numpy()[found]], fk[found])


@pytest.mark.parametrize("impl", IMPLS)
def test_join_shard_with_padding_matches_jax(impl):
    fk, y, pk, x, l_valid, r_valid = _padding_case(np.random.default_rng(42))
    x16 = np.random.default_rng(1).integers(0, 2**16, len(pk), dtype=np.uint16)
    got = join.join_shard(_t(fk), (_t(y),), _t(pk), (_t(x), _t(x16)),
                          left_valid=_t(l_valid), right_valid=_t(r_valid), impl=impl)
    ref = jjoin.join_shard(_j(fk), (_j(y),), _j(pk), (_j(x), _j(x16)),
                           left_valid=_j(l_valid), right_valid=_j(r_valid), impl=impl)
    m = got[3].numpy()
    np.testing.assert_array_equal(m, np.asarray(ref[3]))
    assert m[: len(fk) // 2].all() and not m[len(fk) // 2:].any()
    np.testing.assert_array_equal(got[0].numpy(), fk)
    for g, r in zip(got[2], ref[2]):
        assert g.numpy().dtype == np.asarray(r).dtype  # right columns keep their dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    cols = join.join_result_to_numpy(*got)
    jcols = jjoin.join_result_to_numpy(*ref)
    for c, jc in zip(cols, jcols):
        np.testing.assert_array_equal(c, jc)


@pytest.mark.parametrize("impl", IMPLS)
def test_join_shard_generator_matches_arrow(impl):
    left, right = jax_make_join_tables(1, 1 << 13, 1 << 12)
    lb, rb = left[0], right[0]
    fk, y, pk, x = (np.asarray(a) for a in (lb["fk"], lb["y"], rb["pk"], rb["x"]))
    out = join.join_shard(_t(fk), (_t(y),), _t(pk), (_t(x),), impl=impl)
    assert bool(out[3].all())  # the generator's guaranteed-match contract
    got = np.stack(join.join_result_to_numpy(*out))
    expect = pa.table({"fk": fk, "y": y}).join(
        pa.table({"pk": pk, "x": x}), keys="fk", right_keys="pk", join_type="inner")
    exp = np.stack([expect[c].to_numpy() for c in ("fk", "y", "x")])
    np.testing.assert_array_equal(got[:, np.lexsort(got[::-1])], exp[:, np.lexsort(exp[::-1])])


# ---- hashing / cuckoo table --------------------------------------------------

def test_wang_hash_matches_numpy():
    rng = np.random.default_rng(0)
    k = np.concatenate([rng.integers(0, 2**32, 10000, dtype=np.uint32),
                        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)])
    np.testing.assert_array_equal(wang_hash(_t(k)).numpy(), wang_hash_np(k))


@pytest.mark.parametrize("n, load", [(5000, 0.5), (3000, 0.9)])
def test_ht_build_probe_match_jax(n, load):
    rng = np.random.default_rng(n)
    keys = rng.choice(np.uint32(2**32 - 1), n, replace=False).astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    valid = rng.random(n) < 0.9
    cap = hashtable.table_capacity(n, load)
    assert cap == jht.table_capacity(n, load)
    table = hashtable.ht_build(_t(keys), _t(vals), cap, valid=_t(valid))
    jtable = jht.ht_build(_j(keys), _j(vals), cap, valid=_j(valid))
    assert bool(table.ok) == bool(jtable.ok)
    stats, jstats = table.stats(), jtable.stats()
    assert {k: stats[k] for k in ("capacity", "occupied", "converged")} == {
        k: jstats[k] for k in ("capacity", "occupied", "converged")}
    q = np.concatenate([keys, rng.integers(0, 2**32, 2000, dtype=np.uint32),
                        np.array([0xFFFFFFFF], np.uint32)])
    v, f = hashtable.ht_probe(table, _t(q))
    jv, jf = jht.ht_probe(jtable, _j(q))
    f = f.numpy()
    np.testing.assert_array_equal(f, np.asarray(jf))
    np.testing.assert_array_equal(v.numpy()[f], np.asarray(jv)[f])
    np.testing.assert_array_equal(f[:n], valid)  # every valid key found
    np.testing.assert_array_equal(v.numpy()[:n][valid], vals[valid])
    assert not f[-1]  # EMPTY is never a key


def test_ht_build_not_converged_matches_jax():
    # a full table cannot converge: ok is false in both, the result empty
    keys = np.arange(64, dtype=np.uint32)
    table = hashtable.ht_build(_t(keys), _t(keys), 32, max_rounds=8)
    jtable = jht.ht_build(_j(keys), _j(keys), 32, max_rounds=8)
    assert not bool(table.ok) and not bool(jtable.ok)
    assert int(table.rounds) == int(jtable.rounds) == 8
    with pytest.raises(ValueError, match="power of two"):
        hashtable.ht_build(_t(keys), _t(keys), 48)
