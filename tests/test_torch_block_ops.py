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


def _full_range_inputs(rows, nblk, seed):
    """nblk blocks of int32 values and indices over the whole int32 range,
    negative values and the +-2^31 edges included; for cprep's compare to
    count both ways, a third of the indices lie near (x >> 7)."""
    rng = np.random.default_rng(seed)
    shape = (nblk * rows, 128)
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    x.flat[: len(EDGE)] = EDGE
    idx = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    near = (x.astype(np.int64) >> 7) + rng.integers(-2, 3, shape)
    idx = np.where(rng.random(shape) < 1 / 3, near, idx).astype(np.int32)
    idx.flat[-len(EDGE):] = EDGE
    return x, idx


@pytest.mark.parametrize("op, kernel, rows", CASES, ids=[c[0] for c in CASES])
def test_block_op_matches_pallas_kernel_full_range_idx(script, op, kernel, rows):
    """3 blocks, reps 17 (the roll's shift cycles past 4 four times), idx over
    the whole int32 range: only idx & 127, & 255 or bits 0 and 4 count,
    except in cprep, which compares the whole idx."""
    x, idx = _full_range_inputs(rows, 3, 17 + rows)
    want = _pallas(getattr(script, kernel), op, 17, rows, x, idx)
    got = bo.block_op(torch.from_numpy(x), torch.from_numpy(idx), op, 17)
    np.testing.assert_array_equal(got.numpy(), want)


# block_op_plan at 1, 64 (the ops probe's shape) and 264 blocks, worked by
# hand from csrc/block_ops.cu's geometry: where 2048 values a block
# (256 threads of 8); lane_roll, lane_gather, sq_gather 16 rows a block (8
# warps of 2 rows), gathers 2 buffers x 16 rows x 512 B; row_roll, cprep,
# sublane_gather 4 strips of 32 columns a TPU block, 8 warps, row_roll one
# staged 256 x 32 strip and 2 x 8 warps x 4 edge rows of 32, cprep two 128
# x 33-word strips (x, idx), sublane_gather two 256 x 32 buffers;
# transpose one tile a block, two 128 x 132-word buffers;
# count_matmul one tile a block, 128 KiB of planes
PLANS = {
    "where": [("elementwise", 16, 256, 0), ("elementwise", 1024, 256, 0),
              ("elementwise", 4224, 256, 0)],
    "lane_roll": [("row", 16, 256, 0), ("row", 1024, 256, 0), ("row", 4224, 256, 0)],
    "lane_gather": [("row", 16, 256, 16384), ("row", 1024, 256, 16384),
                    ("row", 4224, 256, 16384)],
    "sq_gather": [("row", 8, 256, 16384), ("row", 512, 256, 16384), ("row", 2112, 256, 16384)],
    "row_roll": [("column", 4, 256, 40960), ("column", 256, 256, 40960),
                 ("column", 1056, 256, 40960)],
    "cprep": [("column", 4, 256, 33792), ("column", 256, 256, 33792),
              ("column", 1056, 256, 33792)],
    "sublane_gather": [("strip", 4, 256, 65536), ("strip", 256, 256, 65536),
                       ("strip", 1056, 256, 65536)],
    "transpose": [("tile", 1, 1024, 135168), ("tile", 64, 1024, 135168),
                  ("tile", 264, 1024, 135168)],
    "count_matmul": [("tensor_core", 1, 256, 131072), ("tensor_core", 64, 256, 131072),
                     ("tensor_core", 264, 256, 131072)],
}


@pytest.mark.parametrize("nblk", [1, 64, 264])
@pytest.mark.parametrize("op", bo.OPS + bo.COPS)
def test_block_op_plan_hand_worked(op, nblk):
    plan = bo.block_op_plan(op, nblk)
    assert tuple(plan) == PLANS[op][[1, 64, 264].index(nblk)]
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.smem <= 232448  # the most shared memory a block may take


def test_block_op_plan_covers_the_card_at_the_probe_shapes():
    """At the probes' shapes (64 blocks of 256 rows, 128 tiles of 128) every
    op but the transpose (one whole tile a block) and count_matmul (its
    kernel unchanged) launches at least one block on each of 132 SMs."""
    for op in bo.OPS + bo.COPS:
        grid = bo.block_op_plan(op, 64 if op in bo.OPS else 128).grid
        if op in ("transpose", "count_matmul"):
            assert grid == 128
        else:
            assert grid >= 132, op
    with pytest.raises(ValueError, match="must be one of"):
        bo.block_op_plan("nope", 1)


# ---- the kernels' lane layouts, run in torch against block_op_ref ----------

def _rand_block(op, nblk, seed):
    x, idx = _full_range_inputs(bo.ROWS[op], nblk, seed)
    return torch.from_numpy(x), torch.from_numpy(idx)


def _unrolled_shifts(reps):
    """The shifts of the rolls' rep loops: 1, 2, 3, 4 an iteration while four
    reps remain, then 1, 2, 3 for the rest."""
    full = reps // 4 * [1, 2, 3, 4]
    return full + [1, 2, 3][: reps - len(full)]


@pytest.mark.parametrize("reps", [0, 1, 3, 4, 5, 16, 17])
def test_lane_roll_shuffle_map(reps):
    """row_kernel<LANE_ROLL>: lane l holds columns 4l .. 4l + 3 of a row
    (v[row, l, k]); a roll by S takes the S high registers of lane l - 1 and
    moves the rest up by S."""
    x, idx = _rand_block("lane_roll", 2, reps)
    v = x.view(-1, 32, 4).clone()
    src = (torch.arange(32) + 31) % 32
    for s in _unrolled_shifts(reps):
        p = v[:, src, :]  # the shuffle from lane l - 1
        v = torch.cat([p[:, :, 4 - s:], v[:, :, : 4 - s]], dim=2)
    np.testing.assert_array_equal(v.reshape(x.shape).numpy(),
                                  bo.block_op_ref(x, idx, "lane_roll", reps).numpy())


@pytest.mark.parametrize("reps", [0, 1, 3, 5, 16, 17])
def test_row_roll_warp_edges(reps):
    """roll_rows_kernel: lane = column of a 32-column strip, warp w holding
    rows 32w .. 32w + 31 in registers; a roll by S moves them up by S and
    takes the first S from the previous warp's last S rows (mod 256)."""
    x, idx = _rand_block("row_roll", 3, reps)
    v = x.view(-1, 8, 32, 128).clone()  # (blocks, warp, row of the warp, column)
    prev = (torch.arange(8) + 7) % 8
    for s in _unrolled_shifts(reps):
        edge = v[:, prev, 32 - s:]  # what the previous warp wrote
        v = torch.cat([edge, v[:, :, : 32 - s]], dim=2)
    np.testing.assert_array_equal(v.reshape(x.shape).numpy(),
                                  bo.block_op_ref(x, idx, "row_roll", reps).numpy())


@pytest.mark.parametrize("reps", [0, 1, 2, 17])
def test_cprep_warp_columns(reps):
    """cprep_kernel: warp w of a strip's block holds columns 4w .. 4w + 3,
    lane l rows l + 32k of each; a lane counts its four rows and the warp
    sums the 32 counts (__reduce_add_sync); the add and clamp then run on
    the lane's rows in wrapping int32."""
    x, idx = _rand_block("cprep", 3, reps)
    # (blocks, k, lane, column): row 32k + lane
    v, iv = (t.view(-1, 4, 32, 128).to(torch.int64) for t in (x, idx))
    for t in range(reps):
        cnt = ((v >> 7) < iv).sum(dim=1, keepdim=True)  # each lane's four rows
        add = cnt.sum(dim=2, keepdim=True) + t  # over the warp's lanes
        v = (((v + add + 2**31) & 0xFFFFFFFF) - 2**31).clamp(0, 2**30)
    np.testing.assert_array_equal(v.to(torch.int32).reshape(x.shape).numpy(),
                                  bo.block_op_ref(x, idx, "cprep", reps).numpy())


def _banks(words):
    return np.asarray(words) % 32


def test_column_strip_banks():
    """The column kernels' shared-memory accesses, a warp at a time: row_roll's
    row-major strip and edge rows take one word a lane (bank = lane);
    cprep's strips at pitch 33 take the staging stores (rows 4i .. 4i + 3,
    8 lanes a row, column 4 (lane & 7) + k) and the column reads (rows
    lane + 32k of one column) on 32 banks."""
    lane = np.arange(32)
    assert (_banks(np.arange(256)[:, None] * 32 + lane) == lane).all()
    pitch = 33
    for i in range(128 // 4):
        for k in range(4):
            words = (4 * i + (lane >> 3)) * pitch + 4 * (lane & 7) + k
            assert len(set(_banks(words))) == 32
    for col in range(32):
        for k in range(4):
            assert len(set(_banks((lane + 32 * k) * pitch + col))) == 32


@pytest.mark.parametrize("reps", [0, 1, 2, 17])
def test_sublane_gather_strip_lanes(reps):
    """strip_kernel: thread (warp w, lane c) owns rows w + 8j of column c of a
    256 x 32 strip; a rep reads row (idx + t) & 255 of its column from one
    buffer and writes its rows into the other: every access of a warp hits
    bank c = lane, and the rows of a column are covered once."""
    x, idx = _rand_block("sublane_gather", 2, reps)
    rows = (torch.arange(8)[:, None] + 8 * torch.arange(32)[None, :]).ravel()
    assert sorted(rows.tolist()) == list(range(256))
    v = x.view(-1, 256, 4, 32).to(torch.int64)  # (blocks, row, strip, lane)
    ib = idx.view(-1, 256, 4, 32).to(torch.int64) & 255
    for t in range(reps):
        src = (ib[:, rows] + t) & 255
        to = torch.empty_like(v)
        to[:, rows] = torch.gather(v, 1, src)
        v = to
    words = np.arange(256)[:, None] * 32 + np.arange(32)[None, :]
    assert (_banks(words) == np.arange(32)).all()
    np.testing.assert_array_equal(v.to(torch.int32).reshape(x.shape).numpy(),
                                  bo.block_op_ref(x, idx, "sublane_gather", reps).numpy())


@pytest.mark.parametrize("reps", [0, 1, 2, 17])
def test_row_gather_byte_packed_indices(reps):
    """row_kernel's gathers: idx & 127 kept a byte a lane value, (ib + t *
    0x01010101) & 0x7F7F7F7F is (idx + t) & 127 in each byte (no carries),
    and the rows are gathered from the warp's copy of them."""
    x, idx = _rand_block("lane_gather", 2, reps)
    lanes = idx.view(-1, 32, 4).to(torch.int64) & 127
    ib = (lanes << torch.tensor([0, 8, 16, 24])).sum(dim=-1)
    v = x.view(-1, 128)
    for t in range(reps):
        src = (ib + (t & 127) * 0x01010101) & 0x7F7F7F7F
        cols = (src[..., None] >> torch.tensor([0, 8, 16, 24])) & 127
        assert torch.equal(cols, (lanes + t) & 127)
        v = torch.gather(v, 1, cols.view(-1, 128))
    np.testing.assert_array_equal(v.numpy(),
                                  bo.block_op_ref(x, idx, "lane_gather", reps).numpy())


def test_transpose_tile_banks():
    """tile_kernel at pitch 132: a rep's four scalar reads (32 lanes on 32
    consecutive rows r of one source row) hit 32 banks, its 16-byte store
    (8 lanes of a phase on 8 rows) hits 32 banks, and the threads' (r, c)
    pairs cover the tile once."""
    pitch = bo.PITCH
    assert pitch * 4 % 16 == 0
    tid = np.arange(1024)
    r, c0 = tid & 127, 4 * (tid >> 7)
    cells = [(int(a), int(b) + 32 * j) for a, b in zip(r, c0) for j in range(4)]
    assert len(set(cells)) == 128 * 32
    for warp in range(32):
        lr, lc = r[32 * warp: 32 * warp + 32], c0[32 * warp: 32 * warp + 32]
        for j in range(4):
            for k in range(4):
                assert len(set(_banks((lc + 32 * j + k) * pitch + lr))) == 32
            for phase in range(4):
                start = (lr * pitch + lc + 32 * j)[8 * phase: 8 * phase + 8]
                assert len(set(_banks(np.concatenate([start + k for k in range(4)])))) == 32
