"""Sort of a uint32 key plane with payload planes following (counterpart of
``dpu_olap_tpu/ops/sort_pallas.py:sort_bitonic``).

``sort_bitonic`` launches the hand-written bitonic sort of ``csrc/sort.cu``
for CUDA tensors and runs the plain version ``sort_bitonic_ref`` for CPU
tensors; any other device raises. Contract (sort_pallas.py:385-471):
ascending unsigned order of ``planes[0]``, payloads follow their key, ties
may permute payloads, and any length >= 2 is accepted; the kernel pads to a
power of two with key and payload 0xFFFFFFFF (``hashtable.EMPTY``), so real
keys must stay below it for their payloads to be exact.

``sort_tiles`` runs the sort's tile stage alone (``dpu_sort_tiles_u32``:
the counterpart of ``scripts/measure_filter.py`` measure_sort's
``upto_inblock``, every merge round that fits on chip): the planes padded
as above to npow, each tile of min(npow, TILE) elements sorted, ascending at
even tile indices and descending at odd ones, as a bitonic network leaves
them for its next round (ascending when one tile covers npow). It returns
all npow rows. The tile sort is unstable, so ``canonical_tiles`` orders the
rows of each tile by every plane before two results are compared.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

MAX_PAYLOADS = 8  # payload planes the kernel takes (csrc/sort.cu MAX_PAYLOADS)
MIN_LEN = 128  # smallest padded length the kernel takes (csrc/sort.cu MIN_LEN)
TILE = 4096  # elements of one shared-memory tile (csrc/sort.cu TILE)
LAUNCHES = 0  # kernel launches by sort_bitonic (the CPU path adds none)
TILE_LAUNCHES = 0  # kernel launches by sort_tiles


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


def _padded_len(n: int) -> int:
    return max(MIN_LEN, 1 << (n - 1).bit_length())


def _launch(entry: str, planes: tuple, dev: torch.device) -> list:
    """Run a sort entry point of csrc/sort.cu on CUDA planes; returns the
    npow-long outputs."""
    if dev.type != "cuda":
        raise ValueError(f"sort_bitonic runs on cuda or cpu tensors, got {dev}")
    if not all(p.is_contiguous() for p in planes):
        raise ValueError("sort_bitonic planes must be contiguous")
    n = planes[0].shape[0]
    npow = _padded_len(n)
    outs = [torch.empty(npow, dtype=torch.uint32, device=dev) for _ in planes]
    ptrs = ctypes.c_void_p * len(planes)
    with torch.cuda.device(dev):
        rc = getattr(_kernels.library(), entry)(
            ptrs(*[p.data_ptr() for p in planes]),
            ptrs(*[o.data_ptr() for o in outs]),
            len(planes), n, npow, _kernels.stream_handle(dev),
        )
    _kernels.check(rc, entry)
    return outs


def sort_bitonic(planes) -> tuple:
    """Sort planes[0] ascending with planes[1:] following; returns new
    tensors. CUDA tensors go to the kernel (on the current stream, without
    synchronising), CPU tensors to ``sort_bitonic_ref``."""
    global LAUNCHES
    planes = tuple(planes)
    dev = _check_planes(planes)
    if dev.type == "cpu":
        return sort_bitonic_ref(planes)
    outs = _launch("dpu_sort_u32", planes, dev)
    LAUNCHES += 1
    n = planes[0].shape[0]
    return tuple(o[:n] for o in outs)


def sort_tiles_ref(planes) -> tuple:
    """Plain PyTorch version of sort_tiles: the planes padded with
    0xFFFFFFFF to npow, each tile's rows in the stable ascending order of
    the key, the odd tiles' orders reversed."""
    planes = tuple(planes)
    _check_planes(planes)
    n = planes[0].shape[0]
    npow = _padded_len(n)
    tile = min(npow, TILE)
    dev = planes[0].device
    pad = torch.full((npow - n,), -1, dtype=torch.int32, device=dev)
    padded = [torch.cat([p.view(torch.int32), pad]).view(-1, tile) for p in planes]
    order = torch.sort(padded[0].view(torch.uint32).to(torch.int64), dim=1, stable=True).indices
    order[1::2] = order[1::2].flip(1)
    return tuple(torch.gather(p, 1, order).reshape(-1).view(torch.uint32) for p in padded)


def sort_tiles(planes) -> tuple:
    """The tile stage of sort_bitonic: npow-long planes whose tiles are
    sorted in alternating directions (see the module's docstring). CUDA
    tensors go to the kernel, CPU tensors to ``sort_tiles_ref``."""
    global TILE_LAUNCHES
    planes = tuple(planes)
    dev = _check_planes(planes)
    if dev.type == "cpu":
        return sort_tiles_ref(planes)
    outs = _launch("dpu_sort_tiles_u32", planes, dev)
    TILE_LAUNCHES += 1
    return tuple(outs)


def canonical_tiles(planes, tile: int = TILE) -> tuple:
    """Each tile of the equal-length uint32 planes with its rows in
    ascending order of (planes[0], planes[1], ...): two unstable tile sorts
    of the same input agree after it. The length must be a multiple of
    ``tile`` (or shorter than it: one tile)."""
    planes = tuple(planes)
    tile = min(tile, planes[0].shape[0])
    cols = [p.view(torch.uint32).to(torch.int64).view(-1, tile) for p in planes]
    order = torch.arange(tile, device=cols[0].device).expand_as(cols[0])
    for c in reversed(cols):  # least significant plane first, each sort stable
        order = torch.gather(order, 1, torch.sort(torch.gather(c, 1, order), dim=1,
                                                  stable=True).indices)
    return tuple(torch.gather(p.view(torch.int32).view(-1, tile), 1, order).reshape(-1)
                 .view(torch.uint32) for p in planes)
