"""Gather of a uint32 table at ascending positions, and the sorted-stream
take built on it (counterpart of ``dpu_olap_tpu/ops/take_pallas.py``:
``gather_sorted_pallas``, ``takeable_sorted``, ``take_sorted`` and
``take_sorted_stream``).

``gather_sorted`` launches ``csrc/gather.cu`` for CUDA tensors and runs the
plain version ``gather_sorted_ref`` for CPU tensors; any other device raises.
``val[j] = data[sidx[j]]`` where ``sidx[j] < len(data)`` and 0 elsewhere.
The TPU kernel's slice and window geometry has no counterpart here: a
per-thread gather cannot overflow, so the returned flag is always 0 (the
kernel writes it, so a call is one launch). It stays in the API so that the
join's 5-tuple and its overflow check keep their shape. sidx may be any
contiguous uint32 tensor, a slice at any offset included.

``take_sorted`` turns a random take into the sort kernel, this gather and a
second sort (take_pallas.py:278-379): sort (clipped index, position), gather
at the sorted indices, sort (position, value) back into query order.
``take_sorted_stream`` skips the last sort and returns values in ascending
index order with their positions.
"""

from __future__ import annotations

import torch

from . import _kernels
from .sort_cuda import sort_bitonic, sortable_bitonic

LAUNCHES = 0  # kernel launches by gather_sorted (the CPU path adds none)


def _check(data: torch.Tensor, sidx: torch.Tensor) -> torch.device:
    for name, t in (("data", data), ("sidx", sidx)):
        if t.dtype != torch.uint32 or t.dim() != 1:
            raise ValueError(f"gather_sorted {name} must be 1-D uint32")
    if data.device != sidx.device:
        raise ValueError("gather_sorted data and sidx must share one device")
    if data.shape[0] == 0:
        raise ValueError("gather_sorted needs a non-empty table")
    return data.device


def gather_sorted_ref(data: torch.Tensor, sidx: torch.Tensor):
    """Plain PyTorch version: clamp, index (as int32 bit patterns), mask."""
    s = sidx.to(torch.int64)
    val = data.view(torch.int32)[s.clamp(max=data.shape[0] - 1)]
    val = torch.where(s < data.shape[0], val, 0).view(torch.uint32)
    return val, torch.zeros((), dtype=torch.int32, device=data.device)


def gather_sorted(data: torch.Tensor, sidx: torch.Tensor):
    """(val, overflow): val[j] = data[sidx[j]], 0 where sidx[j] >= len(data).
    CUDA tensors go to the kernel (on the current stream, without
    synchronising), CPU tensors to ``gather_sorted_ref``."""
    global LAUNCHES
    dev = _check(data, sidx)
    if dev.type == "cpu":
        return gather_sorted_ref(data, sidx)
    if dev.type != "cuda":
        raise ValueError(f"gather_sorted runs on cuda or cpu tensors, got {dev}")
    if not (data.is_contiguous() and sidx.is_contiguous()):
        raise ValueError("gather_sorted inputs must be contiguous")
    out = torch.empty(sidx.shape[0], dtype=torch.uint32, device=dev)
    flag = torch.empty((), dtype=torch.int32, device=dev)  # the kernel writes 0
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_gather_sorted_u32(
            data.data_ptr(), data.shape[0], sidx.data_ptr(), out.data_ptr(),
            sidx.shape[0], flag.data_ptr(), _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "gather_sorted")
    LAUNCHES += 1
    return out, flag


def takeable_sorted(n_data: int, n_idx: int) -> bool:
    """Shape gate for take_sorted: a non-empty table whose row numbers fit
    in uint32, and at least one query."""
    return 1 <= n_data < 1 << 32 and 1 <= n_idx <= 1 << 31


def _sort(planes: tuple) -> tuple:
    """sort_bitonic, which needs two rows; one row is already sorted."""
    return sort_bitonic(planes) if sortable_bitonic(planes[0].shape[0]) else planes


def _stream_take(data: torch.Tensor, indices: torch.Tensor):
    """Shared sort->gather core: (spos, val, flag) over the k queries in
    ascending order of their clipped index, spos each one's query position.
    The sort is stable and pads nothing, so every position keeps its own
    query (the finding recorded at take_pallas.py:301-315 cannot arise)."""
    if data.dim() != 1 or data.element_size() != 4 or indices.dim() != 1:
        raise ValueError("take_sorted takes a 1-D column of 4-byte values and 1-D indices")
    n, k = data.shape[0], indices.shape[0]
    if not takeable_sorted(n, k):
        raise ValueError(f"take_sorted cannot take {k} queries from {n} rows")
    idxc = (indices.to(torch.int64) & 0xFFFFFFFF).clamp(max=n - 1).to(torch.uint32)
    pos = torch.arange(k, device=data.device).to(torch.uint32)
    sidx, spos = _sort((idxc, pos))
    bits = data if data.dtype == torch.uint32 else data.view(torch.uint32)
    val, flag = gather_sorted(bits.contiguous(), sidx)
    return spos, val, flag


def take_sorted(data: torch.Tensor, indices: torch.Tensor):
    """(out, flag): out[i] = data[indices[i]] with clip semantics, through
    sort -> gather -> sort. flag is the gather's overflow flag, always 0."""
    spos, val, flag = _stream_take(data, indices)
    return _sort((spos, val))[1].view(data.dtype), flag


def take_sorted_stream(data: torch.Tensor, indices: torch.Tensor):
    """Order-free take: (pos, val, flag) in ascending-index stream order,
    val[j] = data[clip(indices[pos[j]])], both of length k. It skips the
    restore sort, for consumers that aggregate, sort again or scatter."""
    spos, val, flag = _stream_take(data, indices)
    return spos, val.view(data.dtype), flag
