"""Gather of a uint32 table at ascending positions (counterpart of
``dpu_olap_tpu/ops/take_pallas.py:gather_sorted_pallas``).

``gather_sorted`` launches ``csrc/gather.cu`` for CUDA tensors and runs the
plain version ``gather_sorted_ref`` for CPU tensors; any other device raises.
``val[j] = data[sidx[j]]`` where ``sidx[j] < len(data)`` and 0 elsewhere.
The TPU kernel's slice and window geometry has no counterpart here: a
per-thread gather cannot overflow, so the returned flag is always 0. It stays
in the API so that the join's 5-tuple and its overflow check keep their
shape.
"""

from __future__ import annotations

import torch

from . import _kernels

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


def _no_overflow(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def gather_sorted_ref(data: torch.Tensor, sidx: torch.Tensor):
    """Plain PyTorch version: clamp, index (as int32 bit patterns), mask."""
    s = sidx.to(torch.int64)
    val = data.view(torch.int32)[s.clamp(max=data.shape[0] - 1)]
    val = torch.where(s < data.shape[0], val, 0).view(torch.uint32)
    return val, _no_overflow(data.device)


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
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_gather_sorted_u32(
            data.data_ptr(), data.shape[0], sidx.data_ptr(), out.data_ptr(),
            sidx.shape[0], _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "gather_sorted")
    LAUNCHES += 1
    return out, _no_overflow(dev)
