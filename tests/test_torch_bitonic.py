"""Parity of the port's bitonic merge (dpu_olap_tpu_torch.ops.bitonic_cuda
and merge.bitonic_merge) with the JAX package's Pallas kernel
bitonic_merge_blocks and merge_xla.bitonic_merge, run in interpret mode on
the CPU. Both keep each slot's own pair on a tie, so the plain cascade
equals the TPU kernel bit for bit, payloads of tied keys included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops.bitonic_pallas import bitonic_merge_blocks as jax_merge_blocks
from dpu_olap_tpu.ops.merge_xla import bitonic_merge as jax_bitonic_merge
from dpu_olap_tpu_torch.ops import bitonic_cuda, merge
from dpu_olap_tpu_torch.ops.bitonic_cuda import bitonic_merge_blocks
from dpu_olap_tpu_torch.ops.merge import bitonic_merge


def _bitonic_blocks(rng, n, block, hi, n_pay):
    """Planes whose every block is an ascending run then a descending run;
    keys drawn below ``hi`` (a small hi makes many ties)."""
    key = rng.integers(0, hi, n, dtype=np.uint32).reshape(-1, 2, block // 2)
    key.sort(axis=2)
    key[:, 1] = key[:, 1, ::-1]
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
    return [key.reshape(n), *pays]


def _run_both(planes, **kw):
    got = bitonic_merge_blocks(tuple(map(torch.from_numpy, planes)), **kw)
    return [t.numpy() for t in got]


@pytest.mark.parametrize("n_pay", [0, 1, 3])
@pytest.mark.parametrize("hi", [16, 2**32])
def test_merge_blocks_matches_jax_bit_for_bit(n_pay, hi):
    rng = np.random.default_rng(n_pay * 7 + (hi == 16))
    block = 8 * 128
    planes = _bitonic_blocks(rng, 4 * block, block, hi, n_pay)
    got = _run_both(planes, block_rows=8)
    ref = [np.asarray(a) for a in jax_merge_blocks(
        tuple(map(jnp.asarray, planes)), block_rows=8, interpret=True)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    k = got[0].reshape(-1, block)
    assert np.all(k[:, 1:] >= k[:, :-1])  # every block sorted
    np.testing.assert_array_equal(np.sort(k, axis=1), np.sort(planes[0].reshape(-1, block), axis=1))


@pytest.mark.parametrize("block_rows", [1, 2, 32])
def test_merge_blocks_other_blocks_match_jax(block_rows):
    rng = np.random.default_rng(block_rows)
    block = block_rows * 128
    planes = _bitonic_blocks(rng, 2 * max(block, 4096), block, 16, 2)
    got = _run_both(planes, block_rows=block_rows)
    ref = [np.asarray(a) for a in jax_merge_blocks(
        tuple(map(jnp.asarray, planes)), block_rows=block_rows, interpret=True)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_merge_blocks_keys_with_top_bit():
    # the ^0x80000000 int32 view orders like the unsigned key
    rng = np.random.default_rng(1)
    edges = np.array([0, 1, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    key = np.sort(edges[rng.integers(0, len(edges), 256)].reshape(2, 128), axis=1)
    key[1] = key[1, ::-1]
    planes = [key.reshape(256), rng.integers(0, 2**32, 256, dtype=np.uint32)]
    got = _run_both(planes, block_rows=2)
    ref = [np.asarray(a) for a in jax_merge_blocks(
        tuple(map(jnp.asarray, planes)), block_rows=2, interpret=True)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0], np.sort(planes[0]))


@pytest.mark.parametrize("n_pay", [1, 3])
def test_bitonic_merge_matches_jax_at_2_17(n_pay):
    # above one 64Ki block: the cross-block stage, then the block cascade
    rng = np.random.default_rng(17 + n_pay)
    n = 1 << 17
    planes = _bitonic_blocks(rng, n, n, 1 << 12, n_pay)
    got = [t.numpy() for t in bitonic_merge(tuple(map(torch.from_numpy, planes)))]
    ref = [np.asarray(a) for a in jax_bitonic_merge(tuple(map(jnp.asarray, planes)), interpret=True)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0], np.sort(planes[0]))


@pytest.mark.parametrize("n", [1, 64, 4096])
def test_bitonic_merge_below_one_block_matches_jax(n):
    rng = np.random.default_rng(n)
    planes = _bitonic_blocks(rng, n, n, 50, 2) if n > 1 else [np.array([9], np.uint32)] * 3
    got = [t.numpy() for t in bitonic_merge(tuple(map(torch.from_numpy, planes)))]
    ref = [np.asarray(a) for a in jax_bitonic_merge(tuple(map(jnp.asarray, planes)), interpret=True)]
    np.testing.assert_array_equal(got[0], ref[0])

    def canon(ps):
        rows = np.stack(ps)
        return rows[:, np.lexsort(rows[::-1])]

    np.testing.assert_array_equal(canon(got), canon(ref))


def test_bitonic_merge_below_one_block_takes_the_ported_sort(monkeypatch):
    # below 128 the ported sort finishes the merge (on the card its kernel,
    # here its plain version); the merge kernel's wrapper is not reached
    calls = []
    real_sort = merge.sort_bitonic
    monkeypatch.setattr(merge, "sort_bitonic", lambda p: calls.append(len(p)) or real_sort(p))
    monkeypatch.setattr(merge, "bitonic_merge_blocks", lambda *a, **k: pytest.fail("merge kernel"))
    planes = _bitonic_blocks(np.random.default_rng(64), 64, 64, 1 << 20, 2)
    got = [t.numpy() for t in bitonic_merge(tuple(map(torch.from_numpy, planes)))]
    assert calls == [3]
    order = np.argsort(planes[0], kind="stable")
    for g, p in zip(got, planes):
        np.testing.assert_array_equal(g, p[order])
    one = (torch.tensor([9], dtype=torch.uint32),)
    assert bitonic_merge(one)[0] is one[0] and calls == [3]  # one row: already sorted


def test_merge_rejects_bad_shapes():
    u = torch.zeros(256, dtype=torch.uint32)
    with pytest.raises(ValueError, match="power of two"):
        bitonic_merge_blocks((u,), block_rows=3)
    with pytest.raises(ValueError, match="multiple of the block"):
        bitonic_merge_blocks((u[:200],), block_rows=1)
    with pytest.raises(ValueError, match="at most 8"):
        bitonic_merge_blocks((u,) * 10, block_rows=1)
    with pytest.raises(ValueError, match="uint32"):
        bitonic_merge_blocks((u, u.to(torch.int64)), block_rows=1)
    with pytest.raises(ValueError, match="power-of-two length"):
        bitonic_merge((u[:100],))
    before = bitonic_cuda.LAUNCHES
    bitonic_merge((u,))
    assert bitonic_cuda.LAUNCHES == before  # the CPU path launches nothing


def test_merge_plan_by_hand():
    MP = bitonic_cuda.MergePass
    # the sorted-build join's 8Mi block: the 9 stages 4Mi..16Ki in one
    # strided pass of 512 rows x 32, then 16Ki tiles for 8Ki..1
    assert bitonic_cuda.merge_plan(1 << 23, 1 << 23) == (
        MP(1 << 14, 512, 32, tuple(1 << j for j in range(22, 13, -1)), 512, 98304),
        MP(1 << 14, 1, 1 << 14, tuple(1 << j for j in range(13, -1, -1)), 512, 98304),
    )
    # 64Ki blocks at 8Mi: the stages 32Ki and 16Ki, 4 rows of 4096
    assert bitonic_cuda.merge_plan(1 << 23, 1 << 16, n_pay=0) == (
        MP(1 << 14, 4, 4096, (1 << 15, 1 << 14), 512, 65536),
        MP(1 << 14, 1, 1 << 14, tuple(1 << j for j in range(13, -1, -1)), 512, 65536),
    )
    # the smallest block: one tile pass on 128-element tiles (n & -n)
    assert bitonic_cuda.merge_plan(3 * 128, 128) == (MP(128, 1, 128, (64, 32, 16, 8, 4, 2, 1), 3, 768),)
    assert bitonic_cuda.merge_plan(1 << 16, 128)[0] == MP(1 << 14, 1, 1 << 14, (64, 32, 16, 8, 4, 2, 1),
                                                         4, 98304)
    # the largest block with two strided passes (9 + 9 stages), and one more
    big = bitonic_cuda.merge_plan(1 << 32, 1 << 32)
    assert [(p.low_d, p.rows, p.width) for p in big] == [
        (1 << 23, 512, 32), (1 << 14, 512, 32), (1 << 14, 1, 1 << 14)]
    assert big[0].stages[0] == 1 << 31 and big[1].stages[-1] == 1 << 14
    three = bitonic_cuda.merge_plan(1 << 33, 1 << 33)
    assert [(p.low_d, p.rows) for p in three] == [(1 << 24, 512), (1 << 15, 512), (1 << 14, 2),
                                                  (1 << 14, 1)]


def _run_plan(planes, block):
    """The planned passes in plain torch: for each pass, every thread
    block's set gathered (all sets at once), the pass's stages run on it as
    the set's own compare-exchanges (lower set slot = lower element), and
    scattered back."""
    key = planes[0].view(torch.int32) ^ -(1 << 31)  # orders like the unsigned key
    pays = [p.view(torch.int32) for p in planes[1:]]
    n = key.shape[0]
    for p in bitonic_cuda.merge_plan(n, block, len(pays)):
        b = torch.arange(p.ctas)[:, None]
        q = p.low_d // p.width
        slot = torch.arange(p.rows * p.width)[None, :]
        idx = (b // q) * p.low_d * p.rows + (b % q) * p.width + slot // p.width * p.low_d + slot % p.width
        assert torch.equal(idx.reshape(-1).sort().values, torch.arange(n))  # each element once
        k, ps = key[idx], [x[idx] for x in pays]
        for d in p.stages:
            dl = d // p.low_d * p.width if d >= p.low_d else d  # the stage's distance in the set
            lo = slot[(slot & dl) == 0]
            assert torch.equal(idx[:, lo + dl], idx[:, lo] + d)  # the pairs are the cascade's
            swap = k[:, lo] > k[:, lo + dl]
            a, c = k[:, lo], k[:, lo + dl]
            k[:, lo], k[:, lo + dl] = torch.where(swap, c, a), torch.where(swap, a, c)
            for x in ps:
                a, c = x[:, lo], x[:, lo + dl]
                x[:, lo], x[:, lo + dl] = torch.where(swap, c, a), torch.where(swap, a, c)
        key[idx] = k
        pays = [x.clone() for x in pays]  # the first pass's are views of the inputs
        for x, y in zip(pays, ps):
            x[idx] = y
    return ((key ^ -(1 << 31)).view(torch.uint32), *(x.view(torch.uint32) for x in pays))


@pytest.mark.parametrize("n, block, hi, n_pay, shrink", [
    (1 << 17, 1 << 17, 16, 1, False),  # one strided pass of 3 stages, then the tile pass
    (1 << 17, 1 << 15, 2**32, 2, False),  # one strided stage: 2 rows of 8192
    (3 * 128, 128, 4, 1, False),  # the tile pass alone on 128-element tiles
    (1 << 16, 1 << 16, 1, 0, False),  # all keys equal
    (1 << 13, 1 << 13, 16, 1, True),  # SET = 256, 3 stages a pass: two strided passes
    (1 << 14, 1 << 12, 3, 3, True),
])
def test_merge_plan_run_in_torch_equals_plain(monkeypatch, n, block, hi, n_pay, shrink):
    if shrink:  # the same plan at a scale where the rows would be 32 elements of a 256 set
        monkeypatch.setattr(bitonic_cuda, "SET", 256)
        monkeypatch.setattr(bitonic_cuda, "MAX_STRIDED", 3)
    rng = np.random.default_rng(n + block + n_pay)
    planes = tuple(map(torch.from_numpy, _bitonic_blocks(rng, n, block, hi, n_pay)))
    got = _run_plan(planes, block)
    ref = bitonic_cuda.bitonic_merge_blocks_ref(planes, block // 128)
    for g, r in zip(got, ref):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
