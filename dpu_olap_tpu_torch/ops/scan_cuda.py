"""Segmented forward fill (counterpart of ``dpu_olap_tpu/ops/scan_pallas.py``:
``propagate_fill`` and ``propagate_last``).

``propagate_fill`` and ``propagate_last`` launch ``csrc/scan.cu`` for CUDA
tensors and run the plain versions ``propagate_fill_ref`` and
``propagate_last_ref`` for CPU tensors; any other device raises. Contract:

  * ``propagate_fill(values, sentinel)``: every plane takes its value from
    the last position q' <= q where ``values[0] != sentinel``; lanes with no
    such position take the sentinel in every plane (the TPU kernel's
    payload there is whatever its carry held, scan_pallas.py:124-125);
  * ``propagate_last(alive, values)``: the same fill keyed on ``alive``;
    returns ``(has, filled)``, and lanes with no alive position at or before
    them are 0 in every plane (scan_pallas.py:230-233).

Any length is taken: the TPU wrappers' block padding (ops/join.py:76-87)
has no counterpart here. A call is one memset and one launch (a one-sweep
decoupled look-back, ``csrc/scan.cu``); its work memory, allocated by the
wrapper for each call, is ``fill_plan``'s: one 64-bit status word a tile of
TILE lanes and the ticket, 8 * (ceil(n / 4096) + 1) bytes (512 KiB at one
SF=64 round's 256Mi lanes).

``fill_planes`` and ``match_filled`` are the glue around the fill in the
generic co-sort join (ops/merge.py); the keys31 joins run the fill and
match in one kernel of the same file (ops/fill_match_cuda.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _kernels, hashtable
from .filter_cuda import _as_i32

MAX_PLANES = 9  # planes the kernel gathers: a key + 8 payloads (csrc/scan.cu)
TILE = 4096  # elements per block of the kernel (csrc/scan.cu TILE)
LAUNCHES = 0  # kernel launches by propagate_fill / propagate_last
EMPTY = int(hashtable.EMPTY)  # the invalid-key and pad sentinel


def _check_planes(name: str, planes, dtypes) -> torch.device:
    if not planes:
        raise ValueError(f"{name} needs at least one plane")
    if len(planes) > MAX_PLANES:
        raise ValueError(f"{name} takes at most {MAX_PLANES} planes, got {len(planes)}")
    p0 = planes[0]
    for p in planes:
        if p.dtype not in dtypes or p.dim() != 1 or p.shape != p0.shape:
            raise ValueError(f"{name} planes must be 1-D {'/'.join(map(str, dtypes))} of one length")
        if p.device != p0.device:
            raise ValueError(f"{name} planes must share one device")
    if p0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {p0.device}")
    return p0.device


def _source(live: torch.Tensor) -> torch.Tensor:
    """int64 position of the last live lane at or before each lane, or -1."""
    idx = torch.where(live, torch.arange(live.shape[0], device=live.device), -1)
    return torch.cummax(idx, 0).values if idx.numel() else idx


def _gather(planes, src: torch.Tensor, dead: int) -> tuple:
    has = src >= 0
    s = src.clamp(min=0)
    return tuple(
        torch.where(has, p.view(torch.int32)[s], dead).view(p.dtype) for p in planes
    )


def propagate_fill_ref(values, sentinel: int = 0xFFFFFFFF) -> tuple:
    """Plain PyTorch version of propagate_fill."""
    values = tuple(values)
    live = values[0].view(torch.int32) != _as_i32(sentinel)
    return _gather(values, _source(live), _as_i32(sentinel))


def propagate_last_ref(alive: torch.Tensor, values) -> tuple:
    """Plain PyTorch version of propagate_last."""
    src = _source(alive != 0)
    return src >= 0, _gather(tuple(values), src, 0)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> uint32, wrapping modulo 2^32 like u32 arithmetic."""
    return (x & 0xFFFFFFFF).to(torch.uint32)


def _where0(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x where mask, else 0, for a uint32 column."""
    return torch.where(mask, x.view(torch.int32), 0).view(torch.uint32)


def fill_planes(sk: torch.Tensor, is_pk: torch.Tensor, smerged, m_r: int) -> tuple:
    """The planes every co-sort join fills forward: sk (int64 keys, EMPTY
    for invalid lanes) sorted so that each pk row (is_pk; the others are fk
    rows) precedes its fk rows, smerged the payload planes that followed
    the sort. Each pk row's key (EMPTY on the fk rows) and the first m_r
    payloads."""
    return (_u32(torch.where(is_pk, sk, EMPTY)), *smerged[:m_r])


def match_filled(sk: torch.Tensor, is_pk: torch.Tensor, filled, smerged, m_l: int):
    """The match after the fill of fill_planes: keep the fk rows whose
    filled key is their own, and zero the rest. Returns (key, out_l, out_r,
    matched)."""
    pkey = filled[0].to(torch.int64)
    matched = (pkey != EMPTY) & (pkey == sk) & ~is_pk & (sk != EMPTY)
    out_l = tuple(_where0(matched, smerged[k]) for k in range(m_l))
    out_r = tuple(_where0(matched, c) for c in filled[1:])
    return _u32(torch.where(matched, sk, 0)), out_l, out_r, matched


class FillPlan(NamedTuple):
    """How ``csrc/scan.cu`` lays out a call of n lanes: the tiles (one block
    each), then one work buffer of int64 words: a status word a tile, then
    the ticket."""

    tiles: int
    work_words: int


def fill_plan(n: int) -> FillPlan:
    """The fill kernels' launch plan (csrc/scan.cu dpu_fill_u32 and
    dpu_fill_match_u32)."""
    tiles = -(-n // TILE)
    return FillPlan(tiles, tiles + 1)


def _pointers(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(planes, sentinel: int, alive: torch.Tensor | None):
    global LAUNCHES
    dev = planes[0].device
    if not all(p.is_contiguous() for p in planes):
        raise ValueError("fill planes must be contiguous")
    n = planes[0].shape[0]
    outs = [torch.empty(n, dtype=p.dtype, device=dev) for p in planes]
    has = None if alive is None else torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return has, tuple(outs)
    work = torch.empty(fill_plan(n).work_words, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_fill_u32(
            _pointers(planes),
            _pointers(outs),
            len(planes), n, int(sentinel) & 0xFFFFFFFF,
            None if alive is None else alive.data_ptr(),
            None if has is None else has.data_ptr(),
            work.data_ptr(), _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "propagate_fill" if alive is None else "propagate_last")
    LAUNCHES += 1
    return has, tuple(outs)


def propagate_fill(values, sentinel: int = 0xFFFFFFFF) -> tuple:
    """Forward-fill every plane from the last position where values[0] !=
    sentinel (uint32 planes of one length; values[0] is the key). Returns
    new tensors; has = filled[0] != sentinel. CUDA tensors go to the kernel
    (on the current stream, without synchronising), CPU tensors to
    ``propagate_fill_ref``."""
    values = tuple(values)
    dev = _check_planes("propagate_fill", values, (torch.uint32,))
    if dev.type == "cpu":
        return propagate_fill_ref(values, sentinel)
    return _launch(values, sentinel, None)[1]


def propagate_last(alive: torch.Tensor, values) -> tuple:
    """Forward-fill every values plane (uint32 or int32) from the last
    position where ``alive`` is nonzero. Returns (has, filled). CUDA tensors
    go to the kernel, CPU tensors to ``propagate_last_ref``."""
    values = tuple(values)
    dev = _check_planes("propagate_last", values, (torch.uint32, torch.int32))
    if alive.dim() != 1 or alive.shape != values[0].shape or alive.device != dev:
        raise ValueError("propagate_last alive must be 1-D, on the planes' device, of their length")
    if dev.type == "cpu":
        return propagate_last_ref(alive, values)
    if alive.dtype != torch.bool:
        alive = alive != 0
    if not alive.is_contiguous():
        raise ValueError("propagate_last alive must be contiguous")
    return _launch(values, 0, alive)
