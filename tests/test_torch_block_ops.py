"""Parity of the port's in-block primitive ops (dpu_olap_tpu_torch.ops.
block_ops_cuda; CPU path) with scripts/measure_filter.py's Pallas probe
kernels ``_op_kernel`` (the ``ops`` probe) and ``_c_op_kernel`` (``cops``)
run in interpret mode. Integer data: exact comparison.

The script is loaded from its file, which only reads MEASURE_FILTER.json;
its ``record`` and ``measure_*`` functions, which write that file, are
never called: each test builds its own ``pl.pallas_call`` over the kernel
body, as measure_filter.py:469-482 does for its interpret-mode check.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dpu_olap_tpu_torch.ops import block_ops_cuda as bo

REPO = Path(__file__).resolve().parents[1]
NBLK = 2
EDGE = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1, 127, 128, 2**30,
                 2**30 + 1, -129], np.int32)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("measure_filter_script",
                                                  REPO / "scripts" / "measure_filter.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(rows, seed):
    """NBLK blocks of int32 values over the whole range, with values at and
    near +-2^31 and 0 in every block, and lane indices in [0, 128)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, (NBLK, rows * 128), dtype=np.int64).astype(np.int32)
    x[:, : len(EDGE)] = EDGE
    x[:, -len(EDGE):] = EDGE[::-1]
    idx = rng.integers(0, 128, x.shape, dtype=np.int32)
    return x.reshape(NBLK * rows, 128), idx.reshape(NBLK * rows, 128)


def _pallas(kernel, op, reps, rows, x, idx):
    spec = pl.BlockSpec((rows, 128), lambda i: (i, 0))
    f = pl.pallas_call(
        functools.partial(kernel, op, reps),
        grid=(x.shape[0] // rows,),
        in_specs=[spec, spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(x), jnp.asarray(idx)))


CASES = [(op, "_op_kernel", 256) for op in bo.OPS] + [(op, "_c_op_kernel", 128) for op in bo.COPS]


@pytest.mark.parametrize("reps", [2, 16])
@pytest.mark.parametrize("op, kernel, rows", CASES, ids=[c[0] for c in CASES])
def test_block_op_matches_pallas_kernel(script, op, kernel, rows, reps):
    x, idx = _inputs(rows, rows + reps)
    want = _pallas(getattr(script, kernel), op, reps, rows, x, idx)
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    assert bo.ROWS[op] == rows
    got = bo.block_op(tx, ti, op, reps)
    assert got.dtype == torch.int32 and got.shape == tx.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bo.block_op_ref(tx, ti, op, reps).numpy(), want)


@pytest.mark.parametrize("op", bo.OPS + bo.COPS)
def test_block_op_reads_idx_unless_idx_free(script, op):
    """The IDX_FREE ops (whose kernels skip idx's load) give the same result
    for two idx planes, in the Pallas kernel too; every other op differs.
    Values in [0, 2^14), so that v >> 7 falls in idx's range."""
    rows = bo.ROWS[op]
    kernel = script._op_kernel if op in bo.OPS else script._c_op_kernel
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 14, (NBLK * rows, 128), dtype=np.int32)
    idx = [rng.integers(0, 128, x.shape, dtype=np.int32) for _ in range(2)]
    got = [bo.block_op(torch.from_numpy(x), torch.from_numpy(i), op, 3).numpy() for i in idx]
    assert np.array_equal(*got) == (op in bo.IDX_FREE)
    np.testing.assert_array_equal(got[1], _pallas(kernel, op, 3, rows, x, idx[1]))


def test_count_matmul_in_bf16_is_exact():
    x, idx = _inputs(128, 5)
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    np.testing.assert_array_equal(
        bo.block_op_ref(tx, ti, "count_matmul", 4, matmul_dtype=torch.bfloat16).numpy(),
        bo.block_op_ref(tx, ti, "count_matmul", 4).numpy())


def test_roll_direction_is_jnp_roll():
    """roll by 1 along the lanes moves lane 127 to lane 0 (the direction
    pltpu.roll takes in interpret mode)."""
    x = np.tile(np.arange(128, dtype=np.int32), (256, 1))
    got = bo.block_op(torch.from_numpy(x), torch.zeros(256, 128, dtype=torch.int32), "lane_roll", 1)
    assert got[0, :3].tolist() == [127, 0, 1]


@pytest.mark.parametrize("args, match", [
    (("nope", 2), "must be one of"),
    (("lane_roll", -1), "reps must be"),
])
def test_block_op_rejects_bad_arguments(args, match):
    x = torch.zeros(256, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        bo.block_op(x, x, *args)


@pytest.mark.parametrize("op", bo.OPS + bo.COPS)
def test_block_op_takes_only_its_probe_block_shape(op):
    """OPS run on 256-row blocks and COPS on 128-row tiles, the shapes the
    scripts run them at: half a block is refused, two blocks are taken."""
    half = torch.zeros(bo.ROWS[op] // 2, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"whole {bo.ROWS[op]}-row blocks"):
        bo.block_op(half, half, op, 1)
    two = torch.zeros(2 * bo.ROWS[op], 128, dtype=torch.int32)
    assert bo.block_op(two, two, op, 1).shape == two.shape


def test_block_op_rejects_shapes_and_devices():
    x = torch.zeros(256, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="whole 256-row blocks"):
        bo.block_op(x[:100], x[:100], "lane_roll", 1)
    with pytest.raises(ValueError, match="int32"):
        bo.block_op(x.to(torch.int64), x, "lane_roll", 1)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        bo.block_op(x.to("meta"), x.to("meta"), "lane_roll", 1)


def test_cpu_path_counts_no_launch():
    before = dict(bo.LAUNCHES)
    x, idx = _inputs(128, 1)
    bo.block_op(torch.from_numpy(x), torch.from_numpy(idx), "cprep", 2)
    assert bo.LAUNCHES == before
