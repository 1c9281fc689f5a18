"""Sort of a uint32 key plane with payload planes following (counterpart of
``dpu_olap_tpu/ops/sort_pallas.py:sort_bitonic``).

``sort_bitonic`` keeps the TPU sort's name, but the algorithm is now a
stable LSD radix sort (``csrc/radix_sort.cu``: one histogram pass, then four
8-bit digit passes with a decoupled look-back). CUDA tensors go to that
kernel and CPU tensors to the plain version ``sort_bitonic_ref``; any other
device raises. Its contract is stricter than sort_pallas.py:385-410's:
keys come out in ascending unsigned order with their payloads, ties keep
their input order (so the kernel equals ``sort_bitonic_ref`` bit for bit on
every plane), a key equal to 0xFFFFFFFF keeps its own payloads, the outputs
are n long with no pad, and any n from 2 to 2^32 - 1 is accepted with 0 to
``MAX_PAYLOADS`` payload planes. The whole sort is one memset and five
launches on the current stream, with no host synchronisation, so it can be
captured in a CUDA graph.

Work memory, allocated by the wrapper in one buffer and freed when it
returns (``radix_plan``): 8 * (1024 * ceil(n / 4096) + 514) bytes of
look-back words, histograms and tickets, then the ping-pong planes, 4n
bytes each, 1 + payloads of them (``alt_planes``). At one SF=64 shuffle round (n = 256Mi, one
payload) that is 512 MiB of words and two 1 GiB planes beside the 2 GiB of
outputs.

``sort_tiles`` runs the TPU sort's tile stage alone (``dpu_sort_tiles_u32``
in ``csrc/sort.cu``, a bitonic network: the counterpart of
``scripts/measure_filter.py`` measure_sort's ``upto_inblock``, every merge
round that fits on chip): the planes padded with key and payload 0xFFFFFFFF
to npow (a power of two, at least ``MIN_LEN``), each tile of min(npow, TILE)
elements sorted, ascending at even tile indices and descending at odd ones,
as a bitonic network leaves them for its next round (ascending when one
tile covers npow). It returns all npow rows. The tile sort is unstable, so
``canonical_tiles`` orders the rows of each tile by every plane before two
results are compared.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _kernels

MAX_PAYLOADS = 8  # payload planes the kernels take (csrc/radix_sort.cu, sort.cu MAX_PAYLOADS)
MIN_LEN = 128  # smallest padded length of the tile stage (csrc/sort.cu MIN_LEN)
TILE = 4096  # elements of one tile-stage tile (csrc/sort.cu TILE)
RADIX_TILE = 4096  # keys of one radix-pass tile (csrc/radix_sort.cu TILE)
PASSES = 4  # 8-bit digit passes of the radix sort
RADIX = 256  # buckets a digit
# the planes each radix pass reads and writes: the fourth writes the outputs
PASS_PLANES = (("in", "alt"), ("alt", "out"), ("out", "alt"), ("alt", "out"))
LAUNCHES = 0  # calls of sort_bitonic that launched the radix sort (the CPU path adds none)
TILE_LAUNCHES = 0  # kernel launches by sort_tiles


class RadixPlan(NamedTuple):
    """What the radix sort of n keys with n_pay payload planes needs beside
    its outputs, in one work buffer of int64 words: the tiles of each pass
    (one block each); the scratch words (one look-back status word per pass,
    tile and bucket, then the four 256-bucket histograms and the four
    tickets as uint32); and the ping-pong planes of n uint32 after them."""

    tiles: int
    scratch_words: int
    alt_planes: int
    work_words: int


def radix_plan(n: int, n_pay: int) -> RadixPlan:
    """The radix sort's launch plan (csrc/radix_sort.cu dpu_sort_u32)."""
    tiles = -(-n // RADIX_TILE)
    words = PASSES * RADIX * tiles + (PASSES * RADIX + PASSES) // 2
    alt = 1 + n_pay
    return RadixPlan(tiles, words, alt, words + -(-alt * n // 2))


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
    shape, dev = planes[0].shape, planes[0].device
    for p in planes:
        if p.dtype != torch.uint32 or p.shape != shape or len(shape) != 1:
            raise ValueError("sort_bitonic planes must be 1-D uint32 of one length")
        if p.device != dev:
            raise ValueError("sort_bitonic planes must share one device")
    if not sortable_bitonic(shape[0]):
        raise ValueError(f"sort_bitonic needs n >= 2, got {shape[0]}")
    return dev


def sort_bitonic_ref(planes) -> tuple:
    """Plain PyTorch version: a stable sort on the key widened to int64, then
    each plane permuted (moved as int32 bit patterns)."""
    order = torch.sort(planes[0].to(torch.int64), stable=True).indices
    return tuple(p.view(torch.int32)[order].view(torch.uint32) for p in planes)


def _padded_len(n: int) -> int:
    return max(MIN_LEN, 1 << (n - 1).bit_length())


def _cuda_planes(planes: tuple, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"sort_bitonic runs on cuda or cpu tensors, got {dev}")
    if not all(p.is_contiguous() for p in planes):
        raise ValueError("sort_bitonic planes must be contiguous")


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def sort_bitonic(planes) -> tuple:
    """Sort planes[0] ascending and stably with planes[1:] following;
    returns new n-long tensors (views of one buffer). CUDA tensors go to the
    radix sort (on the current stream, without synchronising), CPU tensors
    to ``sort_bitonic_ref``."""
    global LAUNCHES
    planes = tuple(planes)
    dev = _check_planes(planes)
    if dev.type == "cpu":
        return sort_bitonic_ref(planes)
    _cuda_planes(planes, dev)
    n = planes[0].shape[0]
    if n > 0xFFFFFFFF:
        raise ValueError(f"the radix sort takes n < 2^32, got {n}")
    plan = radix_plan(n, len(planes) - 1)
    out = torch.empty((len(planes), n), dtype=torch.uint32, device=dev)
    work = torch.empty(plan.work_words, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_sort_u32(
            _ptrs(planes), len(planes), n, out.data_ptr(), work.data_ptr(),
            _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "dpu_sort_u32")
    LAUNCHES += 1
    return tuple(out.unbind(0))


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
    """The TPU sort's tile stage: npow-long planes whose tiles are sorted in
    alternating directions (see the module's docstring). CUDA tensors go to
    the kernel, CPU tensors to ``sort_tiles_ref``."""
    global TILE_LAUNCHES
    planes = tuple(planes)
    dev = _check_planes(planes)
    if dev.type == "cpu":
        return sort_tiles_ref(planes)
    _cuda_planes(planes, dev)
    n = planes[0].shape[0]
    npow = _padded_len(n)
    outs = [torch.empty(npow, dtype=torch.uint32, device=dev) for _ in planes]
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_sort_tiles_u32(
            _ptrs(planes), _ptrs(outs), len(planes), n, npow, _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "dpu_sort_tiles_u32")
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
