"""In-block bitonic merge cascade (counterpart of
``dpu_olap_tpu/ops/bitonic_pallas.py:bitonic_merge_blocks``).

``bitonic_merge_blocks`` launches ``dpu_merge_blocks_u32`` of
``csrc/sort.cu`` for CUDA tensors and runs the plain version
``bitonic_merge_blocks_ref`` for CPU tensors; any other device raises.
Contract (bitonic_pallas.py:91-99): the half-cleaner cascade d = block/2 ..
1, ascending, on each block of ``block_rows * 128`` elements of the planes
(planes[0] the uint32 key, the others following it); each block comes out
sorted when it went in bitonic. On a tie each slot keeps its own pair
(bitonic_pallas.py:71-72), so kernel and plain version agree bit for bit.

``merge_plan`` gives the kernel's launches, which ``csrc/sort.cu``'s
``run_merge`` mirrors: strided passes for the stages d >= SET, then one tile
pass for the rest. Two passes in all for any block up to 8Mi elements.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _kernels
from .sort_cuda import MAX_PAYLOADS

LANES = 128
DEF_R = 512  # rows per block: 64Ki elements (bitonic_pallas.py DEF_R)
LAUNCHES = 0  # calls of bitonic_merge_blocks that launched the kernel (the CPU path adds none)
SET = 1 << 14  # elements a thread block of a merge pass holds (csrc/sort.cu SET)
MAX_STRIDED = 9  # stages of one strided pass: rows of at least SET >> 9 = 32 elements


class MergePass(NamedTuple):
    """One launch of the merge kernel. Each of its ``ctas`` thread blocks
    owns ``rows`` rows of ``width`` consecutive elements at stride ``low_d``:
    block b's row m, column c is element (b // q) * low_d * rows + (b % q) *
    width + m * low_d + c, with q = low_d // width. It runs the cascade's
    ``stages`` (their distances d, in order) on those elements in
    ``smem_bytes`` of shared memory. The tile pass has one row (width =
    low_d = its tile)."""

    low_d: int
    rows: int
    width: int
    stages: tuple
    ctas: int
    smem_bytes: int


def merge_plan(n: int, block: int, n_pay: int = 1) -> tuple:
    """The merge kernel's passes for n elements in blocks of ``block``
    (csrc/sort.cu run_merge): strided passes of at most MAX_STRIDED stages
    each, from d = block/2 down to SET, then the tile pass, on tiles of
    min(SET, n & -n) elements, for d = min(block, tile)/2 .. 1. A set keeps
    4 bytes an element for the key and, with payloads, 2 for its position."""
    elem = 6 if n_pay else 4
    passes = []
    top = block // 2
    while top >= SET:
        s = min(top.bit_length() - SET.bit_length() + 1, MAX_STRIDED)
        low = top >> (s - 1)
        passes.append(MergePass(low, 1 << s, SET >> s, tuple(low << j for j in range(s - 1, -1, -1)),
                                n // SET, SET * elem))
        top = low // 2
    tile = min(SET, n & -n)
    first = min(block, tile) // 2
    passes.append(MergePass(tile, 1, tile, tuple(first >> j for j in range(first.bit_length())),
                            n // tile, tile * elem))
    return tuple(passes)


def _check(planes, block_rows: int) -> torch.device:
    if not planes:
        raise ValueError("bitonic_merge_blocks needs a key plane")
    if len(planes) - 1 > MAX_PAYLOADS:
        raise ValueError(
            f"bitonic_merge_blocks takes at most {MAX_PAYLOADS} payload planes, got {len(planes) - 1}"
        )
    if block_rows < 1 or block_rows & (block_rows - 1):
        raise ValueError(f"block_rows must be a power of two, got {block_rows}")
    p0 = planes[0]
    for p in planes:
        if p.dtype != torch.uint32 or p.dim() != 1 or p.shape != p0.shape:
            raise ValueError("bitonic_merge_blocks planes must be 1-D uint32 of one length")
        if p.device != p0.device:
            raise ValueError("bitonic_merge_blocks planes must share one device")
    n, block = p0.shape[0], block_rows * LANES
    if n == 0 or n % block:
        raise ValueError(f"n={n} is not a positive multiple of the block {block}")
    if p0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bitonic_merge_blocks runs on cuda or cpu tensors, got {p0.device}")
    return p0.device


def bitonic_merge_blocks_ref(planes, block_rows: int = DEF_R) -> tuple:
    """Plain PyTorch version: the literal cascade, one stage at a time. The
    key is compared through its ``^ 0x80000000`` int32 view, which orders
    like the unsigned key (bitonic_pallas.py:48-51)."""
    planes = tuple(planes)
    block = block_rows * LANES
    key = planes[0].view(torch.int32) ^ -(1 << 31)
    pays = [p.view(torch.int32) for p in planes[1:]]
    n = key.shape[0]
    d = block // 2
    while d >= 1:
        k2 = key.view(n // (2 * d), 2, d)
        lo, hi = k2[:, 0], k2[:, 1]
        swap = lo > hi  # a tie keeps both pairs in place
        key = torch.stack([torch.where(swap, hi, lo), torch.where(swap, lo, hi)], 1).view(n)
        new = []
        for p in pays:
            p2 = p.view(n // (2 * d), 2, d)
            plo, phi = p2[:, 0], p2[:, 1]
            new.append(
                torch.stack([torch.where(swap, phi, plo), torch.where(swap, plo, phi)], 1).view(n)
            )
        pays = new
        d //= 2
    return ((key ^ -(1 << 31)).view(torch.uint32), *(p.view(torch.uint32) for p in pays))


def bitonic_merge_blocks(planes, block_rows: int = DEF_R) -> tuple:
    """Run the ascending in-block cascade on each block_rows*128 block;
    returns new tensors. CUDA tensors go to the kernel (on the current
    stream, without synchronising), CPU tensors to
    ``bitonic_merge_blocks_ref``."""
    global LAUNCHES
    planes = tuple(planes)
    dev = _check(planes, block_rows)
    if dev.type == "cpu":
        return bitonic_merge_blocks_ref(planes, block_rows)
    if not all(p.is_contiguous() for p in planes):
        raise ValueError("bitonic_merge_blocks planes must be contiguous")
    n = planes[0].shape[0]
    outs = [torch.empty(n, dtype=torch.uint32, device=dev) for _ in planes]
    ptrs = ctypes.c_void_p * len(planes)
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_merge_blocks_u32(
            ptrs(*[p.data_ptr() for p in planes]),
            ptrs(*[o.data_ptr() for o in outs]),
            len(planes), n, block_rows * LANES, _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "bitonic_merge_blocks")
    LAUNCHES += 1
    return tuple(outs)
