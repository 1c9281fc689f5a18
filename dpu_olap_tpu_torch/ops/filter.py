"""Stable predicate filter with compaction (counterpart of
``dpu_olap_tpu/ops/filter.py``).

Reference: dpu/shared/kernels/filter.c, a handshake chain of tasklets that
compacts passing elements in input order; the benchmark predicate is
``item < (1 << 30)`` (filter.c:25, about 25% selectivity). The dynamic
result length is carried as a (padded_values, count) pair, and the host
slices late, as the reference host reads ``output_buffer_length`` per DPU
(host/filter/filter_dpu.cc:50-101).

The threshold predicate goes to ``ops/filter_cuda.py``: the hand-written
kernel for a CUDA tensor, its plain version for a CPU tensor; with
FLAGS.enable_trace (ENABLE_TRACE=1) the kernel prints a line a tile. Any other
predicate takes the plain scatter compaction on any device: the scan of the
mask gives each kept element its slot, and one scatter places it
(``filter_cuda.compact_scatter``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import FLAGS
from . import filter_cuda

# The reference benchmark predicate: item < 2^30 (filter.c:25).
FILTER_THRESHOLD = np.uint32(filter_cuda.THRESHOLD)

# v < FILTER_THRESHOLD; the identity of this function selects the kernel
default_predicate = filter_cuda.below_threshold


def filter_count(values: torch.Tensor, predicate: Callable = default_predicate) -> torch.Tensor:
    """Number of values passing ``predicate``, as a 0-d uint32 tensor."""
    return predicate(values).sum().to(torch.uint32)


def _check(values: torch.Tensor) -> None:
    if values.dim() != 1:
        raise ValueError("filter expects a 1-D column (flatten batches first)")


def filter_compact(
    values: torch.Tensor,
    predicate: Callable = default_predicate,
    fill: int = 0,
):
    """Stable compaction: returns (padded_values, count).

    padded_values[:count] are the passing elements in original order;
    padded_values[count:] == fill; count is a 0-d uint32 tensor.
    """
    _check(values)
    if predicate is default_predicate:
        # ENABLE_TRACE=1: v1 with its per-tile print (only v1 carries the
        # hook, as in the JAX package)
        return filter_cuda.filter_compact(values, fill, trace=FLAGS.enable_trace)
    return filter_cuda.compact_scatter(values, predicate(values), fill)


def filter_with_indices(values: torch.Tensor, predicate: Callable = default_predicate):
    """Compact values AND their original row indices (a selection vector,
    as the reference's partition kernel produces, partition.c).
    Returns (padded_values, padded_indices, count): value tail 0, index
    tail n."""
    _check(values)
    if predicate is default_predicate:
        return filter_cuda.filter_with_indices(values, trace=FLAGS.enable_trace)
    return filter_cuda.compact_scatter(values, predicate(values), 0, with_indices=True)
