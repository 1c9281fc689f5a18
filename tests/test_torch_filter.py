"""Parity of the port's filter (dpu_olap_tpu_torch.ops.filter and
ops.filter_cuda, CPU paths) with the JAX package's Pallas filter v1 run in
interpret mode, and with its XLA scatter path for a custom predicate.
Integer data: exact comparison of values, indices and counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops import filter as jax_filter
from dpu_olap_tpu.ops.filter_pallas import (
    DEF_R,
    LANES,
    filter_pallas_padded,
    filter_with_indices_pallas,
)
from dpu_olap_tpu_torch.ops import filter as tfilter
from dpu_olap_tpu_torch.ops import filter_cuda, filter_stages

BLK = DEF_R * LANES  # one block of the TPU kernel: 64Ki values
SIZES = [BLK, 2 * BLK + 17]
T = 1 << 30


def _jax_compact(v, fill=0):
    out, cnt = filter_pallas_padded(jnp.asarray(v), fill=fill, interpret=True)
    return np.asarray(out), int(cnt)


def _jax_with_indices(v):
    """filter_with_indices_pallas on the input padded the way
    ops/filter.py:_filter_with_indices_pallas_padded pads it (that wrapper
    takes no interpret flag): 0xFFFFFFFF up to the block multiple, then
    tails of 0 (values) and n (indices)."""
    n = len(v)
    x = np.concatenate([v, np.full((-n) % BLK, 0xFFFFFFFF, np.uint32)])
    vals, idxs, cnt = filter_with_indices_pallas(jnp.asarray(x), interpret=True)
    c = int(cnt)
    lane = np.arange(n)
    vals = np.where(lane < c, np.asarray(vals)[:n], 0).astype(np.uint32)
    idxs = np.where(lane < c, np.asarray(idxs)[:n], n).astype(np.uint32)
    return vals, idxs, c


def _pattern(name, n, rng):
    i = np.arange(n)
    if name == "random":
        return rng.integers(0, 2**32, n, dtype=np.uint32)
    if name == "all_pass":
        return rng.integers(0, T, n, dtype=np.uint32)
    if name == "none_pass":
        return rng.integers(T, 2**32, n, dtype=np.uint32)
    if name == "alternating":
        return np.where(i % 2 == 0, i % 128, 0xC0000000 + i % 128).astype(np.uint32)
    assert name == "boundary_values"
    edges = np.array([0, T - 1, T, 0xFFFFFFFF], dtype=np.uint32)
    return edges[rng.integers(0, 4, n)]


PATTERNS = ["random", "all_pass", "none_pass", "alternating", "boundary_values"]


@pytest.mark.parametrize("n", SIZES, ids=["one_block", "two_blocks_plus_17"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_filter_compact_matches_jax_pallas(n, pattern):
    v = _pattern(pattern, n, np.random.default_rng(n))
    out, cnt = tfilter.filter_compact(torch.from_numpy(v))
    jout, jcnt = _jax_compact(v)
    assert out.dtype == torch.uint32 and cnt.dtype == torch.uint32 and cnt.dim() == 0
    assert int(cnt) == jcnt == int((v < T).sum())
    np.testing.assert_array_equal(out.numpy(), jout)


@pytest.mark.parametrize("n", SIZES, ids=["one_block", "two_blocks_plus_17"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_filter_with_indices_matches_jax_pallas(n, pattern):
    v = _pattern(pattern, n, np.random.default_rng(n + 1))
    vals, idxs, cnt = tfilter.filter_with_indices(torch.from_numpy(v))
    jvals, jidxs, jcnt = _jax_with_indices(v)
    assert int(cnt) == jcnt
    np.testing.assert_array_equal(vals.numpy(), jvals)
    np.testing.assert_array_equal(idxs.numpy(), jidxs)
    np.testing.assert_array_equal(idxs.numpy()[:jcnt], np.flatnonzero(v < T))


def test_filter_fill_matches_jax_pallas():
    v = _pattern("random", SIZES[1], np.random.default_rng(3))
    out, cnt = tfilter.filter_compact(torch.from_numpy(v), fill=0xDEADBEEF)
    jout, jcnt = filter_pallas_padded(jnp.asarray(v), fill=0xDEADBEEF, interpret=True)
    assert int(cnt) == int(jcnt)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert np.all(out.numpy()[int(cnt):] == 0xDEADBEEF)


@pytest.mark.parametrize("n", [0, 1, 127, 4097])
@pytest.mark.parametrize("pattern", ["boundary_values", "all_pass", "none_pass"])
def test_filter_edge_lengths_against_numpy(n, pattern):
    v = _pattern(pattern, n, np.random.default_rng(n))
    keep = v < T
    out, cnt = tfilter.filter_compact(torch.from_numpy(v), fill=7)
    assert int(cnt) == keep.sum()
    np.testing.assert_array_equal(out.numpy()[: int(cnt)], v[keep])
    assert np.all(out.numpy()[int(cnt):] == 7)
    vals, idxs, cnt = tfilter.filter_with_indices(torch.from_numpy(v))
    np.testing.assert_array_equal(vals.numpy(), np.pad(v[keep], (0, n - keep.sum())))
    np.testing.assert_array_equal(idxs.numpy()[: int(cnt)], np.flatnonzero(keep))
    assert np.all(idxs.numpy()[int(cnt):] == n)


# (numpy/jax predicate, torch predicate): torch has no uint32 compare or
# modulo on the CPU, so the torch side widens to int64
PREDICATES = {
    "odd": (lambda v: v % 2 == 1, lambda t: t.to(torch.int64) % 2 == 1),
    "high_half": (lambda v: (v >> 31) == 1, lambda t: t.to(torch.int64) >= 2**31),
    "every_third": (lambda v: v % 3 == 0, lambda t: t.to(torch.int64) % 3 == 0),
}


@pytest.mark.parametrize("name", list(PREDICATES))
def test_custom_predicate_matches_jax_scatter(name):
    jpred, tpred = PREDICATES[name]
    rng = np.random.default_rng(11)
    v = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    tv = torch.from_numpy(v)
    out, cnt = tfilter.filter_compact(tv, predicate=tpred, fill=5)
    jout, jcnt = jax_filter.filter_compact(jnp.asarray(v), predicate=jpred, impl="scatter", fill=5)
    assert int(cnt) == int(jcnt) == int(jpred(v).sum())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    vals, idxs, cnt = tfilter.filter_with_indices(tv, predicate=tpred)
    jvals, jidxs, jcnt = jax_filter.filter_with_indices(jnp.asarray(v), predicate=jpred, impl="scatter")
    assert int(cnt) == int(jcnt)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(jidxs))
    assert int(tfilter.filter_count(tv, tpred)) == int(jax_filter.filter_count(jnp.asarray(v), jpred))


def test_compaction_of_concatenation_is_concatenation_of_compactions():
    """The operator's per-batch slicing: one compaction of a round's batches,
    cut at cumulative per-batch counts of the same predicate, gives each
    batch's own compaction."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 2**32, (6, 1000), dtype=np.uint32))
    counts = tfilter.default_predicate(x).sum(dim=1).numpy()
    out, total = tfilter.filter_compact(x.reshape(-1))
    assert int(total) == counts.sum()
    ends = np.cumsum(counts)
    for b in range(6):
        own, c = tfilter.filter_compact(x[b].contiguous())
        assert int(c) == counts[b]
        np.testing.assert_array_equal(out.numpy()[ends[b] - counts[b] : ends[b]], own.numpy()[: int(c)])


def test_cpu_path_launches_no_kernel():
    before = filter_cuda.LAUNCHES
    v = torch.from_numpy(np.arange(10, dtype=np.uint32))
    filter_cuda.filter_compact(v)
    filter_cuda.filter_with_indices(v)
    assert filter_cuda.LAUNCHES == before


@pytest.mark.parametrize(
    "call, match",
    [
        (lambda: filter_cuda.filter_compact(torch.zeros(4, dtype=torch.int32)), "uint32"),
        (lambda: filter_cuda.filter_compact(torch.zeros((2, 2), dtype=torch.uint32)), "1-D"),
        (lambda: filter_cuda.filter_compact(torch.zeros(4, dtype=torch.uint32, device="meta")), "cuda or cpu"),
        (lambda: filter_cuda.filter_with_indices(torch.zeros(4, dtype=torch.uint32, device="meta")), "cuda or cpu"),
        (lambda: tfilter.filter_compact(torch.zeros((2, 2), dtype=torch.uint32)), "1-D"),
        (lambda: tfilter.filter_with_indices(torch.zeros((2, 2), dtype=torch.uint32), PREDICATES["odd"][1]), "1-D"),
    ],
    ids=["dtype", "rank", "meta_compact", "meta_indices", "op_rank", "op_rank_custom"],
)
def test_filter_rejects_bad_inputs(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("n, tiles, work_words", [
    (0, 0, 1),  # only the count is written
    (1, 1, 2),
    (filter_cuda.TILE, 1, 2),
    (filter_cuda.TILE + 1, 2, 3),
    (8 << 20, 2048, 2049),
    (64 << 20, 16384, 16385),  # chip_smoke's timed filter: one round at SF=8
    (256 << 20, 65536, 65537),
    ((1 << 32) - 1, 1 << 20, (1 << 20) + 1),  # the most the kernel takes
])
def test_filter_plan_hand_worked(n, tiles, work_words):
    plan = filter_cuda.filter_plan(n)
    assert plan.tiles == tiles
    # one look-back status word per tile, then the ticket
    assert plan.work_words == work_words == tiles + 1


@pytest.mark.parametrize(
    "call, match",
    [
        (lambda: filter_cuda.filter_with_indices(torch.zeros(4, dtype=torch.int32)), "uint32"),
        (lambda: filter_cuda.filter_compact(torch.zeros((), dtype=torch.uint32)), "1-D"),
        (lambda: filter_stages.filter_stage(torch.zeros(4, dtype=torch.uint32), "sweep"), "stage"),
        (lambda: filter_stages.filter_stage(torch.zeros(4, dtype=torch.int64), "full"), "uint32"),
    ],
    ids=["indices_dtype", "scalar", "unknown_stage", "stage_dtype"],
)
def test_filter_argument_checks(call, match):
    with pytest.raises(ValueError, match=match):
        call()
