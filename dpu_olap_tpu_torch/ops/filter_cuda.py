"""Stable compaction of uint32 values below 2^30 (counterpart of
``dpu_olap_tpu/ops/filter_pallas.py`` v1: ``filter_compact_pallas``,
``filter_with_indices_pallas`` and ``filter_pallas_padded``).

``filter_compact`` and ``filter_with_indices`` launch ``csrc/filter.cu`` for
CUDA tensors and run the plain versions ``filter_compact_ref`` and
``filter_with_indices_ref`` for CPU tensors; any other device raises.
Contract (ops/filter.py:71-85, 144-155 of the JAX package), for any length:
  * ``(padded_values, count)``: ``padded_values[:count]`` are the values
    ``v < 2^30`` in input order, ``padded_values[count:] == fill``;
  * ``(values, indices, count)``: the same with ``fill`` 0, and the row
    number of each kept value, the index tail equal to ``n``;
  * ``count`` is a 0-d uint32 tensor on the input's device.
The TPU wrapper pads the input to its block multiple; the kernel here takes
any length below 2^32, so nothing is padded. A call is one memset, the
one-sweep compaction (a decoupled look-back, ``csrc/filter.cu``) and the
tail pass; its work memory, allocated by the wrapper for each call, is
``filter_plan``'s: one 64-bit status word a tile of TILE values and the
ticket. With ``trace`` (FLAGS.enable_trace, set by ENABLE_TRACE=1) the
kernel is the sweep that prints ``filter block <tile> offset <out offset>
kept <count>`` a tile (``dpu_filter_trace_u32``; the TPU kernel's
pl.debug_print, filter_pallas.py:238-241), and the plain version prints the
same lines (``trace_ref``).

``compact_scatter`` is the plain algorithm behind both plain versions (an
inclusive scan of the mask gives each kept value its slot, then one scatter)
and serves ``ops/filter.py`` for other predicates.
``below``, ``check_threshold``, ``on_cpu`` and ``run_entry`` serve the
filter alternates too (``ops/filter_alt_cuda.py``), whose threshold is a
runtime argument.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from . import _kernels

THRESHOLD = 1 << 30  # the reference predicate v < 2^30 (filter.c:25)
TILE = 4096  # elements per block of the kernel (csrc/filter.cu TILE)
LAUNCHES = 0  # kernel launches by filter_compact / filter_with_indices


def _as_i32(x: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def below_threshold(values: torch.Tensor) -> torch.Tensor:
    """The mask ``values < 2^30``. A uint32 column is compared through its
    int32 view (torch has no uint32 compare on the CPU): v < 2^30 exactly
    when its int32 bit pattern lies in [0, 2^30)."""
    if values.dtype == torch.uint32:
        iv = values.view(torch.int32)
        return (iv >= 0) & (iv < THRESHOLD)
    return values < THRESHOLD


def compact_scatter(
    values: torch.Tensor, mask: torch.Tensor, fill: int = 0,
    with_indices: bool = False,
):
    """Plain stable compaction of a uint32 column by ``mask``: returns
    ``(padded, count)`` or, with indices, ``(padded, indices, count)``.
    Each kept row's slot is its inclusive mask prefix minus 1; failed rows
    scatter to a dropped slot n (the JAX package's ``_compact_scatter``)."""
    n = values.shape[0]
    dev = values.device
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask, pos, n)
    out = torch.full((n + 1,), _as_i32(fill), dtype=torch.int32, device=dev)
    out[slot] = values.view(torch.int32)
    count = mask.sum().to(torch.uint32)
    if not with_indices:
        return out[:n].view(torch.uint32), count
    sel = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    sel[slot] = torch.arange(n, device=dev)
    return out[:n].view(torch.uint32), sel[:n].to(torch.uint32), count


def below(values: torch.Tensor, threshold: int) -> torch.Tensor:
    """The mask ``values < threshold`` of a uint32 column for any threshold
    in [0, 2^32), compared in int64 (torch has no uint32 compare on the
    CPU)."""
    return values.to(torch.int64) < threshold


def check_threshold(threshold) -> int:
    """The threshold as an int, or raise if it is no uint32."""
    t = int(threshold)
    if not 0 <= t <= 0xFFFFFFFF:
        raise ValueError(f"filter threshold must be a uint32, got {threshold}")
    return t


def _check(values: torch.Tensor) -> torch.device:
    if values.dtype != torch.uint32 or values.dim() != 1:
        raise ValueError("filter values must be a 1-D uint32 tensor")
    if values.shape[0] >= 1 << 32:
        raise ValueError("filter takes fewer than 2^32 values (uint32 counts and rows)")
    return values.device


def on_cpu(values: torch.Tensor, what: str) -> bool:
    """Check a filter input: True for a CPU tensor (the plain version's),
    False for a CUDA tensor (the kernel's); any other device raises."""
    dev = _check(values)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {dev}")
    return dev.type == "cpu"


def filter_compact_ref(values: torch.Tensor, fill: int = 0):
    """Plain PyTorch version of filter_compact."""
    return compact_scatter(values, below_threshold(values), fill)


def filter_with_indices_ref(values: torch.Tensor):
    """Plain PyTorch version of filter_with_indices."""
    return compact_scatter(values, below_threshold(values), 0, with_indices=True)


def trace_lines(values: torch.Tensor) -> list:
    """The traced kernel's lines for ``values``, in tile order: each tile of
    TILE values with the count of values kept before it and in it."""
    kept = below_threshold(values).to(torch.int64)
    pad = (-kept.shape[0]) % TILE
    kept = torch.cat([kept, kept.new_zeros(pad)]).reshape(-1, TILE).sum(1).tolist()
    lines, off = [], 0
    for t, k in enumerate(kept):
        lines.append(f"filter block {t} offset {off} kept {k}")
        off += k
    return lines


def trace_ref(values: torch.Tensor) -> None:
    """The plain version of the traced kernel's printf: its lines on
    standard output."""
    for line in trace_lines(values):
        print(line)
    sys.stdout.flush()


def run_entry(entry: str, values: torch.Tensor, threshold: int, fill: int,
              with_indices: bool, scratch: torch.Tensor, what: str):
    """Launch one of the filter kernels' C entry points (all take x, n,
    threshold, fill, out, sel or NULL, scratch, count, stream) on a CUDA
    tensor; raise if the launch fails. Returns ``(out, count)`` or ``(out,
    sel, count)``."""
    dev = values.device
    if not values.is_contiguous():
        raise ValueError(f"{what}: filter values must be contiguous")
    n = values.shape[0]
    out = torch.empty(n, dtype=torch.uint32, device=dev)
    sel = torch.empty(n, dtype=torch.uint32, device=dev) if with_indices else None
    count = torch.empty((), dtype=torch.uint32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(_kernels.library(), entry)(
            values.data_ptr(), n, threshold, int(fill) & 0xFFFFFFFF,
            out.data_ptr(), None if sel is None else sel.data_ptr(),
            scratch.data_ptr(), count.data_ptr(), _kernels.stream_handle(dev),
        )
    _kernels.check(rc, what)
    return (out, count) if sel is None else (out, sel, count)


class FilterPlan(NamedTuple):
    """How ``csrc/filter.cu`` lays out a call of n values: the tiles (one
    block each), then one work buffer of int64 words: a status word a tile,
    then the ticket."""

    tiles: int
    work_words: int


def filter_plan(n: int) -> FilterPlan:
    """The filter kernel's launch plan (csrc/filter.cu dpu_filter_u32)."""
    tiles = -(-n // TILE)
    return FilterPlan(tiles, tiles + 1)


def _launch(values: torch.Tensor, fill: int, with_indices: bool, trace: bool):
    global LAUNCHES
    work = torch.empty(filter_plan(values.shape[0]).work_words, dtype=torch.int64,
                       device=values.device)
    entry = "dpu_filter_trace_u32" if trace else "dpu_filter_u32"
    res = run_entry(entry, values, THRESHOLD, fill, with_indices, work, "filter_compact")
    LAUNCHES += 1
    return res


def filter_compact(values: torch.Tensor, fill: int = 0, trace: bool = False):
    """(padded_values, count) of the stable compaction of ``values < 2^30``.
    CUDA tensors go to the kernel (on the current stream, without
    synchronising), CPU tensors to ``filter_compact_ref``; ``trace`` prints
    a line a tile (see the module note)."""
    if on_cpu(values, "filter_compact"):
        if trace:
            trace_ref(values)
        return filter_compact_ref(values, fill)
    return _launch(values, fill, with_indices=False, trace=trace)


def filter_with_indices(values: torch.Tensor, trace: bool = False):
    """(padded_values, padded_indices, count): filter_compact with fill 0,
    plus the kept rows' numbers (tail n). CUDA tensors go to the kernel, CPU
    tensors to ``filter_with_indices_ref``."""
    if on_cpu(values, "filter_with_indices"):
        if trace:
            trace_ref(values)
        return filter_with_indices_ref(values)
    return _launch(values, 0, with_indices=True, trace=trace)
