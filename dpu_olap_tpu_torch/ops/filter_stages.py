"""The v1 filter cut at a stage, to attribute its time (counterpart of the
stage-ablated TPU filter ``scripts/measure_filter.py`` ``_variant_kernel``
/ ``_variant``, section ``parts``).

``filter_stage(values, stage)`` launches ``dpu_filter_stage_u32`` of
``csrc/filter.cu`` for CUDA tensors and runs the plain version for CPU
tensors; the predicate is the TPU variants' ``v < 2^30``. It returns
``(out, tiles, count)``, each the stage's own output (None where the stage
writes none):
  * ``copy``: ``out`` = the values (the tile read and written, pure IO);
    ``count`` = 0;
  * ``count``: ``tiles`` = each tile's kept values (v1's count pass);
    ``count`` = 0;
  * ``scan``: ``tiles`` = the exclusive tile offsets, ``count`` = the total
    (count pass + tile scan; the TPU's ``prefix`` stage);
  * ``full``: the whole v1 filter with fill 0: ``out``, ``tiles`` (its tile
    offsets) and ``count``.
``copy``, ``count`` and ``scan`` cut the two-pass skeleton (a count pass,
a one-block scan, a second read) that filter v3 and v4 use; ``full`` runs
v1, which is one sweep, so the stages' differences do not split its time.
The TPU stages ``lane_levels`` and ``row_levels`` time the levels of its
butterfly network, which the Hopper v1 kernel does not have: they have no
counterpart.
"""

from __future__ import annotations

import torch

from . import _kernels
from .filter_cuda import THRESHOLD, TILE, below, compact_scatter, filter_plan, on_cpu

STAGES = ("copy", "count", "scan", "full")
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
    counts = padded.reshape(ntiles, TILE).sum(dim=1)
    if stage == "count":
        return None, counts.to(torch.uint32), zero
    offs = (torch.cumsum(counts, 0) - counts).to(torch.uint32)
    if stage == "scan":
        return None, offs, mask.sum().to(torch.uint32)
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
    writes_out = stage in ("copy", "full")
    out = torch.empty(n, dtype=torch.uint32, device=dev) if writes_out else None
    tiles = torch.empty(max(1, -(-n // TILE)), dtype=torch.uint32, device=dev)
    count = torch.empty((), dtype=torch.uint32, device=dev)
    work = (torch.empty(filter_plan(n).work_words, dtype=torch.int64, device=dev)
            if stage == "full" else None)
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_filter_stage_u32(
            values.data_ptr(), n, STAGES.index(stage),
            None if out is None else out.data_ptr(), tiles.data_ptr(),
            None if work is None else work.data_ptr(), count.data_ptr(),
            _kernels.stream_handle(dev),
        )
    _kernels.check(rc, f"filter_stage {stage}")
    LAUNCHES += 1
    return out, None if stage == "copy" else tiles[: -(-n // TILE)], count
