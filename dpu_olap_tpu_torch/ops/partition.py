"""Radix hash-partition of a key column (counterpart of
``dpu_olap_tpu/ops/partition.py``).

Reference: dpu/shared/kernels/partition.c — histogram, prefix sum and a
mutex-guarded scatter. As in the JAX package, a partition is a stable
key-grouped reordering:

  bucket     = radix_bucket(key)                   (hashing.py)
  order      = stable argsort(bucket)              -> selection indices
  partitions = key[order]                          -> partition-contiguous
  histogram  = searchsorted(sorted bucket, 0..P)   -> counts, offsets

The stable argsort is ``torch.sort(stable=True)``: the counterpart of XLA's
``jnp.argsort`` in the JAX package, not of a Pallas kernel. The partition
kernel (ops/partition_cuda.py) writes the padded-cell layout of
``lay_cells`` directly.

Columns are uint32 at the public functions; the glue runs in int64 and
moves columns as int32 bit patterns.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .hashing import radix_bucket

_PAD = -1  # 0xFFFFFFFF as an int32 bit pattern: the EMPTY key and sel pad


@dataclasses.dataclass
class PartitionResult:
    """Partition-contiguous reordering of one batch.

    keys[i]              key column reordered so partition p occupies
                         keys[offsets[p] : offsets[p] + counts[p]]
    selection_indices[i] original row index of keys[i] (stable within bucket)
    counts[p]            histogram (kernel_partition_outputs metadata)
    offsets[p]           exclusive prefix sum of counts
    """

    keys: torch.Tensor
    selection_indices: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor


def _take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """col[idx] for a uint32 column, moved as int32 bit patterns."""
    return col.view(torch.int32)[idx].view(torch.uint32)


def radix_partition(keys: torch.Tensor, nr_partitions: int) -> PartitionResult:
    bucket = radix_bucket(keys, nr_partitions).to(torch.int64)
    ordered, order = torch.sort(bucket, stable=True)
    # the histogram from the sorted bucket: where each bucket starts. Not
    # bincount, which reads its bucket range back to the host on a CUDA
    # tensor (a CUDA graph cannot capture that), and no atomics, which all
    # contend on one counter at P = 1
    starts = torch.searchsorted(
        ordered, torch.arange(nr_partitions + 1, dtype=torch.int64, device=keys.device))
    offsets = starts[:-1]
    counts = starts.diff()
    return PartitionResult(
        keys=_take(keys, order),
        selection_indices=order.to(torch.uint32),
        counts=counts.to(torch.uint32),
        offsets=offsets.to(torch.uint32),
    )


def radix_partition_with_payload(
    keys: torch.Tensor, payloads: Tuple[torch.Tensor, ...], nr_partitions: int
):
    """Partition the key column and carry payload columns through the same
    reordering (the reference re-runs a take kernel per value column,
    join_dpu.cc:303-368)."""
    res = radix_partition(keys, nr_partitions)
    order = res.selection_indices.to(torch.int64)
    return res, tuple(_take(p, order) for p in payloads)


def lay_cells(
    res: PartitionResult,
    moved: Tuple[torch.Tensor, ...],
    nr_partitions: int,
    cell_size: int,
    with_sel: bool = False,
):
    """The (P, cell) padded-cell layout of a partition (the JAX package's
    parallel/shuffle.py:137-146): cell p holds partition p's first
    min(count_p, cell) rows; padded lanes hold key 0xFFFFFFFF, payloads 0
    and selection 0xFFFFFFFF. Returns (cells_k, cells_payloads, cells_sel or
    None, counts, overflow) with overflow a 0-d bool: some count > cell."""
    n = res.keys.shape[0]
    dev = res.keys.device
    lane = torch.arange(cell_size, device=dev)
    counts = res.counts.to(torch.int64)
    valid = lane < counts[:, None]
    idx = (res.offsets.to(torch.int64)[:, None] + lane).clamp(max=max(n - 1, 0))

    def cells(col: torch.Tensor, pad: int) -> torch.Tensor:
        if n == 0:
            return torch.full((nr_partitions, cell_size), pad, dtype=torch.int32,
                              device=dev).view(torch.uint32)
        return torch.where(valid, col.view(torch.int32)[idx], pad).view(torch.uint32)

    sel = cells(res.selection_indices, _PAD) if with_sel else None
    overflow = (counts > cell_size).any()
    return cells(res.keys, _PAD), tuple(cells(m, 0) for m in moved), sel, res.counts, overflow
