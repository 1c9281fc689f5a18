"""Sort of a uint32 key plane with payload planes following (counterpart of
``dpu_olap_tpu/ops/sort_pallas.py:sort_bitonic``).

``sort_bitonic`` launches the hand-written bitonic sort of ``csrc/sort.cu``
for CUDA tensors and runs the plain version ``sort_bitonic_ref`` for CPU
tensors; any other device raises. Contract (sort_pallas.py:385-471):
ascending unsigned order of ``planes[0]``, payloads follow their key, ties
may permute payloads, and any length >= 2 is accepted; the kernel pads to a
power of two with key and payload 0xFFFFFFFF (``hashtable.EMPTY``), so real
keys must stay below it for their payloads to be exact.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

MAX_PAYLOADS = 8  # payload planes the kernel takes (csrc/sort.cu MAX_PAYLOADS)
MIN_LEN = 128  # smallest padded length the kernel takes (csrc/sort.cu MIN_LEN)
LAUNCHES = 0  # kernel launches by sort_bitonic (the CPU path adds none)


def sortable_bitonic(n: int) -> bool:
    """sort_bitonic takes any length >= 2."""
    return n >= 2


def _check_planes(planes) -> torch.device:
    if not planes:
        raise ValueError("sort_bitonic needs a key plane")
    if len(planes) - 1 > MAX_PAYLOADS:
        raise ValueError(
            f"sort_bitonic takes at most {MAX_PAYLOADS} payload planes, got {len(planes) - 1}"
        )
    n = planes[0].shape[0] if planes[0].dim() == 1 else -1
    dev = planes[0].device
    for p in planes:
        if p.dtype != torch.uint32 or p.dim() != 1 or p.shape[0] != n:
            raise ValueError("sort_bitonic planes must be 1-D uint32 of one length")
        if p.device != dev:
            raise ValueError("sort_bitonic planes must share one device")
    if not sortable_bitonic(n):
        raise ValueError(f"sort_bitonic needs n >= 2, got {n}")
    return dev


def sort_bitonic_ref(planes) -> tuple:
    """Plain PyTorch version: a stable sort on the key widened to int64, then
    each plane permuted (moved as int32 bit patterns)."""
    order = torch.sort(planes[0].to(torch.int64), stable=True).indices
    return tuple(p.view(torch.int32)[order].view(torch.uint32) for p in planes)


def sort_bitonic(planes) -> tuple:
    """Sort planes[0] ascending with planes[1:] following; returns new
    tensors. CUDA tensors go to the kernel (on the current stream, without
    synchronising), CPU tensors to ``sort_bitonic_ref``."""
    global LAUNCHES
    planes = tuple(planes)
    dev = _check_planes(planes)
    if dev.type == "cpu":
        return sort_bitonic_ref(planes)
    if dev.type != "cuda":
        raise ValueError(f"sort_bitonic runs on cuda or cpu tensors, got {dev}")
    if not all(p.is_contiguous() for p in planes):
        raise ValueError("sort_bitonic planes must be contiguous")
    n = planes[0].shape[0]
    npow = max(MIN_LEN, 1 << (n - 1).bit_length())
    outs = [torch.empty(npow, dtype=torch.uint32, device=dev) for _ in planes]
    ptrs = ctypes.c_void_p * len(planes)
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.dpu_sort_u32(
            ptrs(*[p.data_ptr() for p in planes]),
            ptrs(*[o.data_ptr() for o in outs]),
            len(planes), n, npow, _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "sort_bitonic")
    LAUNCHES += 1
    return tuple(o[:n] for o in outs)
