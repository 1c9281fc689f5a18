"""Exact 64-bit sum of a uint32 column as a (lo32, hi32) pair (counterpart
of ``dpu_olap_tpu/ops/aggregate.py:_sum_pallas_pair``).

``sum_u64_pair`` launches ``csrc/sum.cu`` for CUDA tensors and runs the plain
version ``sum_u64_pair_ref`` for CPU tensors; any other device raises. The
kernel accumulates in native 64-bit integers, so the TPU's 16/16 splits and
block-count guards have no counterpart; it takes any length below 2^32 and
any 4-byte-aligned start (a round's slice may be a view).
"""

from __future__ import annotations

import torch

from . import _kernels

LAUNCHES = 0  # kernel launches by sum_u64_pair (the CPU path adds none)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return (x & 0xFFFFFFFF).to(torch.uint32)


def _check(values: torch.Tensor) -> torch.device:
    if values.dtype != torch.uint32 or values.dim() != 1:
        raise ValueError("sum_u64_pair values must be a 1-D uint32 tensor")
    if values.shape[0] >= 1 << 32:
        raise ValueError("sum_u64_pair takes fewer than 2^32 values (the u64 bound)")
    return values.device


def sum_u64_pair_ref(values: torch.Tensor):
    """Plain PyTorch version: the 16-bit halves summed in int64 (each sum
    < 2^48 for n < 2^32), then folded into (lo32, hi32) without overflow."""
    v = values.to(torch.int64)
    lo = (v & 0xFFFF).sum()
    hi = (v >> 16).sum()
    low = lo + ((hi & 0xFFFF) << 16)  # < 2^49: exact
    return _u32(low), _u32((hi >> 16) + (low >> 32))


def sum_u64_pair(values: torch.Tensor):
    """(lo, hi) 0-d uint32 tensors with sum(values) = hi * 2^32 + lo.
    CUDA tensors go to the kernel (on the current stream, without
    synchronising), CPU tensors to ``sum_u64_pair_ref``."""
    global LAUNCHES
    dev = _check(values)
    if dev.type == "cpu":
        return sum_u64_pair_ref(values)
    if dev.type != "cuda":
        raise ValueError(f"sum_u64_pair runs on cuda or cpu tensors, got {dev}")
    if not values.is_contiguous():
        raise ValueError("sum_u64_pair values must be contiguous")
    out = torch.empty(2, dtype=torch.uint32, device=dev)  # one little-endian u64
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_sum_u32(
            values.data_ptr(), values.shape[0], out.data_ptr(),
            _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "sum_u64_pair")
    LAUNCHES += 1
    return out[0], out[1]
