"""Parity of the port's aggregates (dpu_olap_tpu_torch.ops.aggregate and
ops.sum_cuda, CPU paths) with the JAX package's Pallas sum kernel in
interpret mode, its XLA paths and numpy. Integer sums compare exactly; the
float sum within the JAX tests' relative 1e-5 (tests/test_take_aggregate.py:72),
because its f32 block partials are added in another order than XLA's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops import aggregate as jax_agg
from dpu_olap_tpu.ops.aggregate import _sum_pallas_pair
from dpu_olap_tpu_torch.ops import aggregate, sum_cuda


def _pair_int(pair):
    lo, hi = pair
    assert lo.dtype == torch.uint32 and hi.dtype == torch.uint32 and lo.dim() == 0
    return aggregate.u64_pair_to_int(lo, hi)


@pytest.mark.parametrize("n", [8 * 128, 1 << 17, 3 * 5 * 1024])
def test_sum_u64_pair_matches_jax_pallas(n):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**32, n, dtype=np.uint32)
    v[: n // 2] = 0xFFFFFFFF  # every carry of the TPU's 16/16 splits
    got = sum_cuda.sum_u64_pair(torch.from_numpy(v))
    jlo, jhi = _sum_pallas_pair(jnp.asarray(v), interpret=True)
    assert _pair_int(got) == jax_agg.u64_pair_to_int(np.asarray(jlo), np.asarray(jhi))
    assert int(got[0]) == int(jlo) and int(got[1]) == int(jhi)
    assert _pair_int(got) == int(v.astype(np.uint64).sum())


@pytest.mark.parametrize(
    "n, value",
    [(0, None), (1, None), (12345, None), (1 << 18, 0xFFFFFFFF), (1 << 20, 0xFFFFFFFF)],
)
def test_sum_u64_against_numpy(n, value):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**32, n, dtype=np.uint32) if value is None else np.full(n, value, np.uint32)
    assert aggregate.sum_u64(torch.from_numpy(v)) == int(v.astype(np.uint64).sum())
    assert aggregate.sum_u64(torch.from_numpy(v)) == jax_agg.sum_u64(jnp.asarray(v))


def test_sum_of_a_misaligned_view():
    v = np.random.default_rng(1).integers(0, 2**32, 4099, dtype=np.uint32)
    t = torch.from_numpy(v)[3:]
    assert aggregate.sum_u64(t) == int(v[3:].astype(np.uint64).sum())


def test_sum_casts_other_integer_columns_like_jax():
    v = np.random.default_rng(2).integers(-(2**31), 2**31, 1000, dtype=np.int32)
    assert aggregate.sum_u64(torch.from_numpy(v)) == jax_agg.sum_u64(jnp.asarray(v))


def test_sum_f64_within_relative_1e5():
    v = (np.random.default_rng(3).random(1 << 18) * 1e3).astype(np.float32)
    got = aggregate.sum_f64(torch.from_numpy(v))
    assert abs(got - float(v.astype(np.float64).sum())) <= abs(got) * 1e-5
    assert abs(got - jax_agg.sum_f64(jnp.asarray(v))) <= abs(got) * 1e-5
    parts = aggregate.sum_f64_partials(torch.from_numpy(v[:10000]))
    jparts = np.asarray(jax_agg.sum_f64_partials(jnp.asarray(v[:10000])))
    assert parts.shape == jparts.shape == (2,)
    np.testing.assert_allclose(parts.numpy(), jparts, rtol=1e-5)


def test_min_max_count_and_aggregate():
    v = np.random.default_rng(4).integers(0, 2**32, 5000, dtype=np.uint32)
    v[7] = 0xFFFFFFFF
    t, j = torch.from_numpy(v), jnp.asarray(v)
    assert int(aggregate.min_u32(t)) == int(jax_agg.min_u32(j)) == int(v.min())
    assert int(aggregate.max_u32(t)) == int(jax_agg.max_u32(j)) == 0xFFFFFFFF
    assert aggregate.min_u32(t).dtype == torch.uint32
    for name in ("sum", "min", "max", "count"):
        assert aggregate.aggregate(t, name) == jax_agg.aggregate(j, name), name
    f = v.astype(np.float32)
    got = aggregate.aggregate(torch.from_numpy(f), "sum_double")
    assert abs(got - jax_agg.aggregate(jnp.asarray(f), "sum_double")) <= abs(got) * 1e-5


def test_unknown_aggregator_raises():
    with pytest.raises(ValueError, match="unknown aggregator 'median'"):
        aggregate.aggregate(torch.zeros(3, dtype=torch.uint32), "median")


def test_cpu_path_launches_no_kernel():
    before = sum_cuda.LAUNCHES
    sum_cuda.sum_u64_pair(torch.from_numpy(np.arange(9, dtype=np.uint32)))
    assert sum_cuda.LAUNCHES == before


@pytest.mark.parametrize(
    "values, match",
    [
        (lambda: torch.zeros(4, dtype=torch.int32), "uint32"),
        (lambda: torch.zeros((2, 2), dtype=torch.uint32), "1-D"),
        (lambda: torch.zeros(4, dtype=torch.uint32, device="meta"), "cuda or cpu"),
    ],
    ids=["dtype", "rank", "meta_device"],
)
def test_sum_kernel_wrapper_rejects_bad_inputs(values, match):
    with pytest.raises(ValueError, match=match):
        sum_cuda.sum_u64_pair(values())
