"""Chained in-block primitive ops on (R, 128) int32 blocks (counterpart of
``scripts/measure_filter.py``'s ``_op_kernel``, the ``ops`` probe, and
``_c_op_kernel``, the ``cops`` probe).

``block_op(x, idx, op, reps)`` launches ``csrc/block_ops.cu`` for CUDA
tensors and runs the plain version ``block_op_ref`` for CPU tensors; any
other device raises. Every kernel reads with 16-byte loads, so x, and idx
for an op that reads it, must start 16-byte aligned. x and idx are int32
planes of shape (nblk * ROWS[op], 128); each block of rows runs ``reps``
ops in turn, t = 0 .. reps - 1, in int32 arithmetic that wraps modulo 2^32
(``>>`` is arithmetic):

  OPS (the ``ops`` probe, on (256, 128) blocks, as in the JAX script)
    lane_roll       roll by 1 + (t & 3) along the lanes (``torch.roll``'s
                    direction, which is ``pltpu.roll``'s and ``jnp.roll``'s)
    row_roll        the same along the rows
    where           v where idx & (1 << (t & 4)) else v + 1
    lane_gather     v[r][(idx + t) & 127] along each row
    sublane_gather  v[(idx + t) mod 256][c] along each column
  COPS (the ``cops`` probe, on (128, 128) tiles)
    transpose       v^T + t
    sq_gather       as lane_gather
    count_matmul    v ^ (a^T . b), a = (v & 127) <= ((idx + t) & 127), b =
                    (v >> 7) == (idx & 127), 0/1 planes contracted over the
                    rows
    cprep           clip(v + s0 + t, 0, 2^30), s0 the column counts of
                    (v >> 7) < idx

The block shape is the one each script runs the op at. ``IDX_FREE`` ops
never read idx (the kernel does not load it). The plain version computes
in int64 and wraps; its counting product is an exact float32 matmul of the
0/1 planes (``matmul_dtype=torch.bfloat16`` is exact too: every sum is at
most 128). ``LAUNCHES[op]`` counts each op's kernel launches.

``block_op_plan(op, nblk)`` describes the launch that ``block_op`` makes
(csrc/block_ops.cu's ``plan_of``, and count_matmul's own launch): the op's
skeleton (csrc/block_ops.cu's note says what each does), its grid, threads
a block and bytes of shared memory a block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels

OPS = ("lane_roll", "row_roll", "where", "lane_gather", "sublane_gather")
COPS = ("transpose", "sq_gather", "count_matmul", "cprep")
CODES = {op: i for i, op in enumerate(OPS + COPS)}  # csrc/block_ops.cu's op codes
LANES = 128
ROWS = {**dict.fromkeys(OPS, 256), **dict.fromkeys(COPS, LANES)}  # an op's block rows
IDX_FREE = ("lane_roll", "row_roll", "transpose")  # ops that never read idx
LAUNCHES = dict.fromkeys(OPS + COPS, 0)  # kernel launches of each op


class BlockOpPlan(NamedTuple):
    skeleton: str
    grid: int  # blocks
    threads: int  # a block
    smem: int  # bytes of dynamic shared memory a block


# the kernels' geometry (csrc/block_ops.cu: ew, rw, col, strip, tile, cm)
WHERE_VALUES = 256 * 8  # values a where block: 256 threads of 8
ROW_ROWS = 8 * 2  # rows a row block: 8 warps of 2 rows
STRIP_COLS = 32  # columns a column or strip block
PITCH = LANES + 4  # words a row of the transpose's tile in shared memory


def block_op_plan(op: str, nblk: int) -> BlockOpPlan:
    """The launch of ``op`` on nblk blocks of ROWS[op] rows."""
    if op not in CODES:
        raise ValueError(f"block op must be one of {OPS + COPS}, got {op!r}")
    values = nblk * ROWS[op] * LANES
    strips = nblk * (LANES // STRIP_COLS)
    if op == "where":
        return BlockOpPlan("elementwise", values // WHERE_VALUES, 256, 0)
    if op in ("lane_roll", "lane_gather", "sq_gather"):
        smem = 0 if op == "lane_roll" else 8 * 2 * 2 * LANES * 4  # a warp's rows, twice
        return BlockOpPlan("row", nblk * ROWS[op] // ROW_ROWS, 256, smem)
    if op == "row_roll":  # the staged strip, then 8 warps' 4 edge rows, twice
        return BlockOpPlan("column", strips, 256, (ROWS[op] + 2 * 8 * 4) * STRIP_COLS * 4)
    if op == "cprep":  # the strips of x and idx at a pitch of 33 words
        return BlockOpPlan("column", strips, 256, 2 * ROWS[op] * (STRIP_COLS + 1) * 4)
    if op == "sublane_gather":
        return BlockOpPlan("strip", strips, 256, 2 * ROWS[op] * STRIP_COLS * 4)
    if op == "transpose":
        return BlockOpPlan("tile", nblk, 1024, 2 * LANES * PITCH * 4)
    return BlockOpPlan("tensor_core", nblk, 256, 4 * LANES * LANES * 2)  # count_matmul


def _check(x: torch.Tensor, idx: torch.Tensor, op: str, reps: int) -> torch.device:
    if op not in CODES:
        raise ValueError(f"block op must be one of {OPS + COPS}, got {op!r}")
    if reps < 0:
        raise ValueError(f"block op reps must be >= 0, got {reps}")
    for name, t in (("x", x), ("idx", idx)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != LANES:
            raise ValueError(f"block op {name} must be an int32 (rows, {LANES}) plane")
    if idx.shape != x.shape or x.shape[0] % ROWS[op]:
        raise ValueError(f"block op {op}: x and idx must share a shape of whole {ROWS[op]}-row blocks")
    dev = x.device
    if idx.device != dev:
        raise ValueError("block op x and idx must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"block op runs on cuda or cpu tensors, got {dev}")
    return dev


def _wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it wraps to, kept in int64."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _step(v: torch.Tensor, idx: torch.Tensor, op: str, t: int, matmul_dtype) -> torch.Tensor:
    """One op at step t on v, idx: int64 (blocks, R, 128)."""
    if op == "lane_roll":
        return torch.roll(v, 1 + (t & 3), dims=2)
    if op == "row_roll":
        return torch.roll(v, 1 + (t & 3), dims=1)
    if op == "where":
        return torch.where((idx & (1 << (t & 4))) != 0, v, _wrap(v + 1))
    if op in ("lane_gather", "sq_gather"):
        return torch.gather(v, 2, (idx + t) & (LANES - 1))
    if op == "sublane_gather":
        return torch.gather(v, 1, (idx + t) & (ROWS[op] - 1))
    if op == "transpose":
        return _wrap(v.transpose(1, 2) + t)
    if op == "count_matmul":
        a = ((v & 127) <= ((idx + t) & 127)).to(matmul_dtype)
        b = ((v >> 7) == (idx & 127)).to(matmul_dtype)
        return v ^ torch.matmul(a.transpose(1, 2), b).to(torch.int64)
    s0 = ((v >> 7) < idx).sum(dim=1, keepdim=True)  # cprep
    return _wrap(v + s0 + t).clamp(0, 1 << 30)


def block_op_ref(x: torch.Tensor, idx: torch.Tensor, op: str, reps: int,
                 matmul_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of block_op, in int64 on x's device."""
    _check(x, idx, op, reps)
    shape = (-1, ROWS[op], LANES)
    v = x.reshape(shape).to(torch.int64)
    i = idx.reshape(shape).to(torch.int64)
    for t in range(reps):
        v = _step(v, i, op, t, matmul_dtype)
    return v.to(torch.int32).reshape(x.shape).contiguous()


def block_op(x: torch.Tensor, idx: torch.Tensor, op: str, reps: int) -> torch.Tensor:
    """``reps`` chained ``op`` on each (ROWS[op], 128) block of x, with idx;
    returns a new int32 plane of x's shape. CUDA tensors go to the kernel
    (on the current stream, without synchronising), CPU tensors to
    ``block_op_ref``."""
    dev = _check(x, idx, op, reps)
    if dev.type == "cpu":
        return block_op_ref(x, idx, op, reps)
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("block op x and idx must be contiguous")
    read = (x,) if op in IDX_FREE else (x, idx)
    if any(t.data_ptr() % 16 for t in read):
        names = "x" if op in IDX_FREE else "x and idx"
        raise ValueError(f"block op {op}: {names} must start 16-byte aligned"
                         " (its kernel reads them with 16-byte loads)")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_block_op_i32(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0] // ROWS[op], CODES[op],
            reps, _kernels.stream_handle(dev),
        )
    _kernels.check(rc, f"block op {op}")
    LAUNCHES[op] += 1
    return out
