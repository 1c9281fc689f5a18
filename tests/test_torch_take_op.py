"""Parity of the port's take paths (dpu_olap_tpu_torch.ops.take and the
sorted-stream take of ops.take_cuda, CPU paths) with the JAX package's
take and its Pallas take_sorted in interpret mode. Integer data: exact
comparison. Out-of-range indices clip to data[n-1] on every path."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops.take_pallas import take_sorted as jax_take_sorted
from dpu_olap_tpu.ops.take_pallas import takeable_sorted as jax_takeable_sorted
from dpu_olap_tpu_torch.ops import take, take_cuda

jax_take = importlib.import_module("dpu_olap_tpu.ops.take")  # the package re-exports take()
N, K = 1 << 14, 10000  # K is no power of two


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 2**32, N, dtype=np.uint32)
    idx = rng.integers(0, N, K, dtype=np.uint32)
    idx[:40] = [N, N + 1, 2**31, 0xFFFFFFFF, N - 1] * 8  # clip to n-1
    jout, jflag = jax_take_sorted(jnp.asarray(data), jnp.asarray(idx), interpret=True)
    assert int(jflag) == 0
    return data, idx, np.asarray(jout)


def test_take_sorted_matches_jax(case):
    data, idx, jout = case
    out, flag = take_cuda.take_sorted(torch.from_numpy(data), torch.from_numpy(idx))
    assert out.dtype == torch.uint32 and int(flag) == 0
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(jout, data[np.minimum(idx, N - 1)])


def test_take_sorted_stream_matches_jax(case):
    data, idx, jout = case
    pos, val, flag = take_cuda.take_sorted_stream(torch.from_numpy(data), torch.from_numpy(idx))
    pos, val = pos.numpy().astype(np.int64), val.numpy()
    assert int(flag) == 0 and len(pos) == len(val) == K
    np.testing.assert_array_equal(np.sort(pos), np.arange(K))  # a permutation
    clipped = np.minimum(idx, N - 1)
    assert np.all(np.diff(clipped[pos].astype(np.int64)) >= 0)  # ascending index order
    out = np.empty(K, np.uint32)
    out[pos] = val
    np.testing.assert_array_equal(out, jout)


def test_take_and_take_fast_match_jax(case):
    data, idx, jout = case
    t, i = torch.from_numpy(data), torch.from_numpy(idx)
    np.testing.assert_array_equal(take.take(t, i).numpy(), jout)
    np.testing.assert_array_equal(take.take_fast(t, i).numpy(), jout)
    np.testing.assert_array_equal(
        take.take(t, i).numpy(), np.asarray(jax_take.take(jnp.asarray(data), jnp.asarray(idx)))
    )


def test_take_fill_and_masked_match_jax():
    rng = np.random.default_rng(4)
    # a multiple of 128: JAX's row path, whose fill reads indices unsigned
    # as every port path does (its element path would wrap int32 -1 to n-1)
    n = 1024
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    idx = rng.integers(0, 2 * n, 700).astype(np.uint32)
    idx[:3] = [0xFFFFFFFF, 2**31, n]
    valid = rng.random(700) < 0.7
    t, i = torch.from_numpy(data), torch.from_numpy(idx)
    j, ji = jnp.asarray(data), jnp.asarray(idx)
    np.testing.assert_array_equal(
        take.take(t, i, fill=0xDEADBEEF).numpy(), np.asarray(jax_take.take(j, ji, fill=0xDEADBEEF))
    )
    np.testing.assert_array_equal(
        take.take_masked(t, i, torch.from_numpy(valid)).numpy(),
        np.asarray(jax_take.take_masked(j, ji, jnp.asarray(valid))),
    )
    neg = np.array([-1, 0, 5, -(2**31)], dtype=np.int32)  # int32-negative clip to n-1
    np.testing.assert_array_equal(
        take.take(t, torch.from_numpy(neg)).numpy(), np.asarray(jax_take.take(j, jnp.asarray(neg)))
    )


@pytest.mark.parametrize("n, k", [(5000, 1), (5000, 3), (300, 100), (128, 127), (64, 129)])
def test_take_sorted_below_the_sort_floor_against_numpy(n, k):
    """k < 128 (or just above), below the port sort's padding floor: the
    wrapper pads the queries itself. JAX's takeable_sorted refuses these
    shapes, so numpy is the reference."""
    assert not jax_takeable_sorted(n, k)
    assert take_cuda.takeable_sorted(n, k)
    rng = np.random.default_rng(n + k)
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    idx = rng.integers(0, n + 10, k, dtype=np.uint32)
    out, flag = take_cuda.take_sorted(torch.from_numpy(data), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), data[np.minimum(idx, n - 1)])
    pos, val, _ = take_cuda.take_sorted_stream(torch.from_numpy(data), torch.from_numpy(idx))
    np.testing.assert_array_equal(val.numpy(), data[np.minimum(idx, n - 1)][pos.numpy().astype(np.int64)])


def test_take_sorted_float_column():
    rng = np.random.default_rng(6)
    data = rng.random(4096).astype(np.float32)
    idx = rng.integers(0, 5000, 3000, dtype=np.uint32)
    out, _ = take_cuda.take_sorted(torch.from_numpy(data), torch.from_numpy(idx))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), data[np.minimum(idx, 4095)])


def test_take_sorted_runs_the_sort_and_gather_wrappers(monkeypatch):
    calls = []
    real_sort, real_gather = take_cuda.sort_bitonic, take_cuda.gather_sorted
    monkeypatch.setattr(take_cuda, "sort_bitonic", lambda p: calls.append(("sort", len(p[0]))) or real_sort(p))
    monkeypatch.setattr(take_cuda, "gather_sorted", lambda d, s: calls.append(("gather", len(s))) or real_gather(d, s))
    data = torch.from_numpy(np.arange(1000, dtype=np.uint32))
    take_cuda.take_sorted(data, torch.from_numpy(np.arange(200, dtype=np.uint32)))
    # the k queries go through unpadded
    assert calls == [("sort", 200), ("gather", 200), ("sort", 200)]


@pytest.mark.parametrize(
    "data, k, match",
    [(np.zeros(0, np.uint32), 4, "cannot take"), (np.zeros(8, np.uint32), 0, "cannot take"),
     (np.zeros(8, np.uint64), 4, "4-byte")],
    ids=["empty_table", "no_queries", "wide_column"],
)
def test_take_sorted_rejects_bad_shapes(data, k, match):
    with pytest.raises(ValueError, match=match):
        take_cuda.take_sorted(torch.from_numpy(data), torch.zeros(k, dtype=torch.uint32))
