"""The TPU primitive probes' counterparts (``csrc/probes.cu``): the lane
gather of ``scripts/measure_r3.py``'s ``gk`` (measure_take2, :219) and the
primitives of the lowering probes ``measurements/_probe_v4_lowering.py``,
``_proto_lower.py`` and ``_proto_lower2.py``.

  lane_gather(x, idx)    o[r][j] = x[r][idx[r][j]]: x (rows, W_v) 32-bit,
                         idx (rows, W_i) int32 (W_i may exceed W_v, the wide
                         gather); an index outside [0, W_v) reads 0.
  transpose(x)           the (cols, rows) transpose of a 32-bit plane.
  onehot_matmul(a, b)    a^T . b in float32 for bf16 planes a (K, M) and b
                         (K, N), K, M and N multiples of 16; exact for 0/1
                         planes, as the TPU probe's f32 accumulation is.
  dyn_row(x, row)        the (1, W) row ``row[0]`` of x (rows, W), the index
                         an int32 tensor on x's device that the kernel reads
                         there (the TPU probe keeps it in SMEM); a row
                         outside [0, rows) reads 0.
  noop(device)           one launch of a kernel that does nothing, through
                         the same ctypes path: the probes' launch floor.

Each launches its kernel for CUDA tensors and runs its plain version
(``*_ref``) for CPU tensors; any other device raises. 32-bit planes may be
int32 or uint32, and the outputs keep their dtype. ``LAUNCHES[name]``
counts each function's kernel launches.

``gather_plan(rows, wv, wi)`` is the launch that ``lane_gather`` makes
and the C entry follows: the kernel (a warp a row for rows of at most
ROW_WORDS values, else rows staged a block), the grid and the rows a block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels

PRIMITIVES = ("lane_gather", "transpose", "onehot_matmul", "dyn_row")  # the probes' functions
LAUNCHES = dict.fromkeys((*PRIMITIVES, "noop"), 0)
MAX_GATHER_WIDTH = 2048  # widest value or index row the gather takes (csrc/probes.cu)
_WORDS = (torch.int32, torch.uint32)

# the gathers' kernels, in the order of csrc/probes.cu's kernel codes
GATHER_KERNELS = ("staged", "warp_rows")
ROW_WARPS = 4  # rows a warp_rows block, one a warp
ROW_WORDS = 128  # widest value row the warp_rows kernel takes


class GatherPlan(NamedTuple):
    kernel: str  # one of GATHER_KERNELS
    grid: int  # blocks
    rows_per_block: int


def gather_plan(rows: int, wv: int, wi: int) -> GatherPlan:
    """The launch of lane_gather on (rows, wv) values at (rows, wi) indices:
    a warp a row up to ROW_WORDS values a row (no slower than the staged
    kernel at any row count read, PERF.md §6), else as many rows staged a
    block as fit MAX_GATHER_WIDTH values."""
    if not (1 <= wv <= MAX_GATHER_WIDTH and 1 <= wi <= MAX_GATHER_WIDTH):
        raise ValueError(f"lane_gather rows must be 1 to {MAX_GATHER_WIDTH} wide")
    per = ROW_WARPS if wv <= ROW_WORDS else MAX_GATHER_WIDTH // wv
    return GatherPlan("warp_rows" if wv <= ROW_WORDS else "staged", -(-rows // per), per)


def _device(what: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what} inputs must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} inputs must be contiguous")
    return dev


def _plane(what: str, t: torch.Tensor, dtypes=_WORDS) -> None:
    if t.dtype not in dtypes or t.dim() != 2:
        raise ValueError(f"{what} takes 2-D {' or '.join(map(str, dtypes))} planes, got"
                         f" {t.dtype} of {t.dim()} dims")


def _launch(name: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        rc = getattr(_kernels.library(), f"dpu_{name}")(*args, _kernels.stream_handle(dev))
    _kernels.check(rc, name)


def _check_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.device:
    _plane("lane_gather values", x)
    _plane("lane_gather indices", idx, (torch.int32,))
    if idx.shape[0] != x.shape[0]:
        raise ValueError("lane_gather values and indices must have the same rows")
    if not (1 <= x.shape[1] <= MAX_GATHER_WIDTH and 1 <= idx.shape[1] <= MAX_GATHER_WIDTH):
        raise ValueError(f"lane_gather rows must be 1 to {MAX_GATHER_WIDTH} wide")
    return _device("lane_gather", x, idx)


def lane_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of lane_gather: torch.gather at the clamped
    index, 0 where the index is out of range."""
    _check_gather(x, idx)
    w = x.shape[1]
    i = idx.to(torch.int64)
    got = torch.gather(x.view(torch.int32), 1, i.clamp(0, w - 1))
    return torch.where((i >= 0) & (i < w), got, 0).view(x.dtype)


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """o[r][j] = x[r][idx[r][j]]: a new plane of idx's shape, x's dtype, by
    gather_plan's launch."""
    dev = _check_gather(x, idx)
    if dev.type == "cpu":
        return lane_gather_ref(x, idx)
    plan = gather_plan(x.shape[0], x.shape[1], idx.shape[1])
    out = torch.empty(idx.shape, dtype=x.dtype, device=dev)
    _launch("lane_gather_u32", dev, x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], idx.shape[1], GATHER_KERNELS.index(plan.kernel), plan.grid,
            plan.rows_per_block)
    LAUNCHES["lane_gather"] += 1
    return out


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of transpose."""
    _plane("transpose", x)
    _device("transpose", x)
    return x.t().contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """The (cols, rows) transpose of a 32-bit plane, as a new tensor."""
    _plane("transpose", x)
    dev = _device("transpose", x)
    if dev.type == "cpu":
        return transpose_ref(x)
    if x.shape[0] > 65535 * 32:
        raise ValueError("transpose takes fewer than 65535 * 32 rows (the kernel's grid)")
    out = torch.empty((x.shape[1], x.shape[0]), dtype=x.dtype, device=dev)
    _launch("transpose_u32", dev, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1])
    LAUNCHES["transpose"] += 1
    return out


def _check_onehot(a: torch.Tensor, b: torch.Tensor) -> torch.device:
    _plane("onehot_matmul", a, (torch.bfloat16,))
    _plane("onehot_matmul", b, (torch.bfloat16,))
    if a.shape[0] != b.shape[0]:
        raise ValueError("onehot_matmul contracts the rows: a and b need as many")
    if any(d % 16 or d == 0 for d in (*a.shape, b.shape[1])):
        raise ValueError("onehot_matmul takes sizes that are positive multiples of 16")
    return _device("onehot_matmul", a, b)


def onehot_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of onehot_matmul: the float32 product (exact
    for 0/1 planes)."""
    _check_onehot(a, b)
    return torch.matmul(a.t().float(), b.float())


def onehot_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T . b, float32 (M, N), of bf16 planes a (K, M) and b (K, N)."""
    dev = _check_onehot(a, b)
    if dev.type == "cpu":
        return onehot_matmul_ref(a, b)
    if (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("onehot_matmul planes must start 16-byte aligned (16-byte cp.async)")
    out = torch.empty((a.shape[1], b.shape[1]), dtype=torch.float32, device=dev)
    _launch("onehot_matmul_bf16", dev, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
            a.shape[1], b.shape[1])
    LAUNCHES["onehot_matmul"] += 1
    return out


def _check_row(x: torch.Tensor, row: torch.Tensor) -> torch.device:
    _plane("dyn_row", x)
    if row.dtype != torch.int32 or row.numel() != 1:
        raise ValueError("dyn_row takes its row index as a one-element int32 tensor")
    if x.shape[0] == 0:
        raise ValueError("dyn_row needs a plane with rows")
    return _device("dyn_row", x, row)


def dyn_row_ref(x: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of dyn_row: index_select at the clamped row, 0
    where it is out of range; no value goes back to the host."""
    _check_row(x, row)
    r = row.reshape(1).to(torch.int64)
    got = x.view(torch.int32).index_select(0, r.clamp(0, x.shape[0] - 1))
    return torch.where(((r >= 0) & (r < x.shape[0])).reshape(1, 1), got, 0).view(x.dtype)


def dyn_row(x: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """The (1, W) row ``row[0]`` of x, read on x's device."""
    dev = _check_row(x, row)
    if dev.type == "cpu":
        return dyn_row_ref(x, row)
    out = torch.empty((1, x.shape[1]), dtype=x.dtype, device=dev)
    _launch("dyn_row_u32", dev, x.data_ptr(), row.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1])
    LAUNCHES["dyn_row"] += 1
    return out


def noop(device: torch.device | str = "cuda") -> None:
    """One launch of a kernel that does nothing, on ``device``'s current
    stream, through the probes' ctypes path: the least time a probe's
    launch can take. Its plain version, for a CPU device, does nothing."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"noop runs on a cuda or cpu device, got {dev}")
    _launch("noop", dev)
    LAUNCHES["noop"] += 1
