"""Parity of the port's sort (dpu_olap_tpu_torch.ops.sort_cuda) with the JAX
package's Pallas merge-tree sort, run in interpret mode on the CPU.

Integer data, so the comparison is exact: keys bit for bit, and the
(key, payload...) rows after a canonical lexsort, since both sorts are
unstable on ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops.sort_pallas import sort_bitonic as jax_sort_bitonic
from dpu_olap_tpu_torch.ops import sort_cuda
from dpu_olap_tpu_torch.ops.hashtable import EMPTY


def _canon(cols):
    rows = np.stack([np.asarray(c) for c in cols])
    return rows[:, np.lexsort(rows[::-1])]


def _keys(rng, n):
    """Keys over the whole u32 range below EMPTY, with many duplicates."""
    k = rng.integers(0, int(EMPTY), n, dtype=np.uint32)
    dup = rng.choice(n, n // 4, replace=False)
    k[dup] = rng.integers(2**31, 2**31 + 50, n // 4, dtype=np.uint32)
    return k


@pytest.mark.parametrize("n", [1 << 13, (1 << 13) + 37])
@pytest.mark.parametrize("n_pay", [1, 3])
def test_sort_matches_jax_sort_bitonic(n, n_pay):
    rng = np.random.default_rng(n + n_pay)
    key = _keys(rng, n)
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
    got = sort_cuda.sort_bitonic(tuple(torch.from_numpy(a) for a in (key, *pays)))
    exp = jax_sort_bitonic(tuple(jnp.asarray(a) for a in (key, *pays)), interpret=True)
    got = [t.numpy() for t in got]
    exp = [np.asarray(e) for e in exp]
    assert all(g.dtype == np.uint32 and g.shape == (n,) for g in got)
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(_canon(got), _canon(exp))
    np.testing.assert_array_equal(_canon(got), _canon([key, *pays]))


def test_sort_key_only_and_minimum_length():
    k = torch.from_numpy(np.array([0xFFFFFFFE, 2**31], np.uint32))
    (s,) = sort_cuda.sort_bitonic((k,))
    np.testing.assert_array_equal(s.numpy(), [2**31, 0xFFFFFFFE])
    assert sort_cuda.sortable_bitonic(2) and not sort_cuda.sortable_bitonic(1)


def test_sort_cpu_path_launches_no_kernel():
    before = sort_cuda.LAUNCHES
    k = torch.from_numpy(np.arange(16, dtype=np.uint32)[::-1].copy())
    sort_cuda.sort_bitonic((k, k))
    assert sort_cuda.LAUNCHES == before


def _u32(n):
    return torch.zeros(n, dtype=torch.uint32)


@pytest.mark.parametrize(
    "planes, match",
    [
        (lambda: (), "key plane"),
        (lambda: (_u32(8),) * 10, "at most 8 payload"),
        (lambda: (torch.zeros(8, dtype=torch.int32),), "uint32"),
        (lambda: (_u32(8), _u32(7)), "one length"),
        (lambda: (_u32(1),), "n >= 2"),
        (lambda: (_u32(8).reshape(2, 4),), "1-D"),
        (lambda: (torch.zeros(8, dtype=torch.uint32, device="meta"),), "cuda or cpu"),
    ],
    ids=["empty", "too_many_payloads", "dtype", "ragged", "short", "2d", "meta_device"],
)
def test_sort_rejects_bad_planes(planes, match):
    with pytest.raises(ValueError, match=match):
        sort_cuda.sort_bitonic(planes())
