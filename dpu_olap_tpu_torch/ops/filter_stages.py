"""The v1 filter cut at a stage of its own kernel, to attribute its time
(counterpart of the stage-ablated TPU filter ``scripts/measure_filter.py``
``_variant_kernel`` / ``_variant``, section ``parts``).

``filter_stage(values, stage)`` launches ``dpu_filter_stage_u32`` of
``csrc/filter.cu`` for CUDA tensors and runs the plain version for CPU
tensors; the predicate is the TPU variants' ``v < 2^30``. Every stage is
one memset of ``filter_plan``'s work words (status words and ticket) and
one launch of v1's sweep kernel, with v1's ticket, launch bounds and grid,
cut where the stage ends (``full`` adds v1's tail pass). Each reads the
input once and writes n values (8n bytes; ``lookback`` writes only the
count's values), so the differences between
consecutive stages split v1's time: IO, predicate and count, rank and
staging, look-back, tail. It returns ``(out, tiles, count)``, each as the
kernel writes it (None where the stage writes none):
  * ``copy``: the tile's 16-byte loads stored back in place: ``out`` = the
    values; ``count`` = 0;
  * ``count``: + the predicate, three ballots a row and the tile total:
    ``out`` = the values; ``tiles`` = each tile's kept values; ``count`` =
    0;
  * ``prefix``: + the ranks and the kept values staged in shared memory,
    written at the tile's own base with zeros up to the tile's end: ``out``
    = each tile's own compaction; ``tiles`` = the counts; ``count`` = 0;
  * ``lookback``: + publish and the warp look-back, the run written at its
    global offset (v1's sweep without its tail pass): ``out[:count]`` =
    v1's; ``out[count:]`` is not written, so it is compared on
    ``[:count]`` only (the plain version leaves zeros there); ``tiles`` =
    the exclusive tile offsets; ``count`` = the total;
  * ``full``: the whole v1 filter with fill 0: ``out``, ``tiles`` (its tile
    offsets) and ``count``.
The TPU stages ``lane_levels`` and ``row_levels`` time the levels of its
butterfly network, which the Hopper v1 kernel does not have: they have no
counterpart.
"""

from __future__ import annotations

import torch

from . import _kernels
from .filter_cuda import THRESHOLD, TILE, below, compact_scatter, filter_plan, on_cpu

STAGES = ("copy", "count", "prefix", "lookback", "full")
LAUNCHES = 0  # kernel launches by filter_stage


def filter_stage_ref(values: torch.Tensor, stage: str):
    """Plain PyTorch version of filter_stage."""
    n = values.shape[0]
    dev = values.device
    zero = torch.zeros((), dtype=torch.uint32, device=dev)
    if stage == "copy":
        return values.clone(), None, zero
    mask = below(values, THRESHOLD)
    ntiles = -(-n // TILE)
    padded = torch.zeros(ntiles * TILE, dtype=torch.int64, device=dev)
    padded[:n] = mask
    tiled = padded.reshape(ntiles, TILE)
    counts = tiled.sum(dim=1)
    if stage == "count":
        return values.clone(), counts.to(torch.uint32), zero
    if stage == "prefix":
        # each kept value to its tile's base plus its rank within the tile
        rank = (torch.cumsum(tiled, 1) - 1).reshape(-1)[:n]
        base = torch.arange(n, device=dev) // TILE * TILE
        slot = torch.where(mask, base + rank, n)
        out = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        out[slot] = values.view(torch.int32)
        return out[:n].view(torch.uint32), counts.to(torch.uint32), zero
    offs = (torch.cumsum(counts, 0) - counts).to(torch.uint32)
    out, count = compact_scatter(values, mask, 0)
    return out, offs, count


def filter_stage(values: torch.Tensor, stage: str):
    """(out, tiles, count) of the v1 filter run up to ``stage``. CUDA
    tensors go to the kernels (on the current stream, without
    synchronising), CPU tensors to ``filter_stage_ref``."""
    global LAUNCHES
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if on_cpu(values, "filter_stage"):
        return filter_stage_ref(values, stage)
    if not values.is_contiguous():
        raise ValueError("filter_stage: filter values must be contiguous")
    n = values.shape[0]
    dev = values.device
    plan = filter_plan(n)
    out = torch.empty(n, dtype=torch.uint32, device=dev)
    tiles = torch.empty(max(1, plan.tiles), dtype=torch.uint32, device=dev)
    count = torch.empty((), dtype=torch.uint32, device=dev)
    work = torch.empty(plan.work_words, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_filter_stage_u32(
            values.data_ptr(), n, STAGES.index(stage), out.data_ptr(), tiles.data_ptr(),
            work.data_ptr(), count.data_ptr(), _kernels.stream_handle(dev),
        )
    _kernels.check(rc, f"filter_stage {stage}")
    LAUNCHES += 1
    return out, None if stage == "copy" else tiles[: plan.tiles], count
