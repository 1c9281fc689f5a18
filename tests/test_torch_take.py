"""Parity of the port's sorted gather (dpu_olap_tpu_torch.ops.take_cuda) with
the JAX package's Pallas streaming gather, run in interpret mode on the CPU.
Integer data: exact comparison."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops.take_pallas import gather_sorted_pallas
from dpu_olap_tpu_torch.ops import take_cuda


@pytest.mark.parametrize(
    "n, k, dup",
    [(16 << 10, 4 << 10, False), (8 << 10, 2 << 10, True), (4 << 10, 8 << 10, False)],
    ids=["uniform", "duplicates_and_gaps", "more_queries_than_rows"],
)
def test_gather_matches_jax_gather_sorted_pallas(n, k, dup):
    rng = np.random.default_rng(n + k)
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    raw = rng.integers(0, n, k, dtype=np.uint32)
    if dup:  # heavy duplication + whole slices with no queries
        raw = np.where(raw % 3 == 0, raw % 7, raw % (n // 4)).astype(np.uint32)
    sidx = np.sort(raw)
    val, ovf = take_cuda.gather_sorted(torch.from_numpy(data), torch.from_numpy(sidx))
    jval, jovf = gather_sorted_pallas(
        jnp.asarray(data), jnp.asarray(sidx), window_rows=256, interpret=True
    )
    assert int(jovf) == 0 and int(ovf) == 0
    assert val.dtype == torch.uint32 and ovf.dtype == torch.int32 and ovf.dim() == 0
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(val.numpy(), data[sidx])


def test_gather_out_of_range_positions_read_zero():
    rng = np.random.default_rng(5)
    n = 1000
    data = rng.integers(1, 2**32, n, dtype=np.uint32)  # no zeros in the table
    sidx = np.sort(
        np.concatenate([rng.integers(0, n, 200), [n, n + 1, 2**31, 0xFFFFFFFF]])
    ).astype(np.uint32)
    val, ovf = take_cuda.gather_sorted(torch.from_numpy(data), torch.from_numpy(sidx))
    exp = np.where(sidx < n, data[np.minimum(sidx, n - 1)], 0)
    np.testing.assert_array_equal(val.numpy(), exp)
    assert int(ovf) == 0


def test_gather_cpu_path_launches_no_kernel():
    before = take_cuda.LAUNCHES
    d = torch.from_numpy(np.arange(8, dtype=np.uint32))
    take_cuda.gather_sorted(d, d)
    assert take_cuda.LAUNCHES == before


@pytest.mark.parametrize(
    "data, sidx, match",
    [
        (lambda: torch.zeros(8, dtype=torch.int32), lambda: torch.zeros(4, dtype=torch.uint32), "data"),
        (lambda: torch.zeros(8, dtype=torch.uint32), lambda: torch.zeros(4, dtype=torch.int64), "sidx"),
        (lambda: torch.zeros(0, dtype=torch.uint32), lambda: torch.zeros(4, dtype=torch.uint32), "non-empty"),
        (
            lambda: torch.zeros(8, dtype=torch.uint32, device="meta"),
            lambda: torch.zeros(4, dtype=torch.uint32, device="meta"),
            "cuda or cpu",
        ),
        (
            lambda: torch.zeros(8, dtype=torch.uint32),
            lambda: torch.zeros(4, dtype=torch.uint32, device="meta"),
            "one device",
        ),
    ],
    ids=["data_dtype", "sidx_dtype", "empty_table", "meta_device", "mixed_devices"],
)
def test_gather_rejects_bad_inputs(data, sidx, match):
    with pytest.raises(ValueError, match=match):
        take_cuda.gather_sorted(data(), sidx())


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("offset", [0, 1])
def test_gather_plain_ragged_and_offset_queries(k, offset):
    """k queries that are not a multiple of 4, from a slice of sidx at an
    offset (the kernel's scalar head and tail), against numpy."""
    rng = np.random.default_rng(10 * k + offset)
    n = 37
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    raw = np.sort(rng.integers(0, n + 4, k + offset).astype(np.uint32))
    sidx = torch.from_numpy(raw)[offset:]
    assert sidx.storage_offset() == offset and sidx.is_contiguous()
    val, ovf = take_cuda.gather_sorted(torch.from_numpy(data), sidx)
    s = raw[offset:]
    np.testing.assert_array_equal(val.numpy(), np.where(s < n, data[np.minimum(s, n - 1)], 0))
    assert val.shape == (k,) and int(ovf) == 0
