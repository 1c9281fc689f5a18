"""The dense-pk join (counterpart of ``dpu_olap_tpu/ops/merge_xla.py:142-229``).

When the build side's pk is dense (pk[i] = pk[0] + i, checked on the host by
the operator; always true for the reference generator's sequential pk,
host/generator/generator.cc:59-71), the probe is a positional lookup: sort
the probe side by ``fk - pk0`` and gather each build payload at the sorted
positions. The sorted-build and fused co-sort joins are not ported yet
(ROADMAP §1 item 5).

uint32 glue arithmetic runs in int64 and narrows back with ``& 0xFFFFFFFF``,
which reproduces the JAX package's wrapping u32 subtraction exactly; masking
moves uint32 columns as int32 bit patterns.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .sort_cuda import sort_bitonic, sortable_bitonic
from .take_cuda import gather_sorted


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> uint32, wrapping modulo 2^32 like u32 arithmetic."""
    return (x & 0xFFFFFFFF).to(torch.uint32)


def _where0(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x where mask, else 0, for a uint32 column."""
    return torch.where(mask, x.view(torch.int32), 0).view(torch.uint32)


def join_dense_eligible(n_l: int, n_r: int) -> bool:
    """The dense-pk join needs a sortable probe side and a non-empty build
    side (the gather kernel has no slice geometry to fill)."""
    return sortable_bitonic(n_l) and n_r >= 1


def join_shard_dense(
    left_fk: torch.Tensor,
    left_payload: Tuple[torch.Tensor, ...],
    right_pk: torch.Tensor,
    right_payload: Tuple[torch.Tensor, ...],
):
    """Join 1-D uint32 columns against a DENSE pk column.

    Returns (key, out_l, out_r, matched, overflow) with exactly n_l rows in
    key-sorted order: fks outside the pk range are unmatched, and their key
    and payloads are 0. ``overflow`` is a 0-d int32 tensor, always 0 here
    (the gather has no window); the tuple keeps the JAX package's shape."""
    n_r = right_pk.shape[0]
    lo = right_pk[:1].to(torch.int64)
    idx = _u32(left_fk.to(torch.int64) - lo)  # out-of-range wraps huge, masked

    sorted_ = sort_bitonic((idx, *left_payload))
    sidx, sys_ = sorted_[0], sorted_[1:]
    sidx64 = sidx.to(torch.int64)
    matched = sidx64 < n_r

    overflow = torch.zeros((), dtype=torch.int32, device=left_fk.device)
    out_r = []
    for x in right_payload:
        val, f = gather_sorted(x, sidx)  # 0 where unmatched: no mask needed
        overflow |= f
        out_r.append(val)

    key = _where0(matched, _u32(sidx64 + lo))
    out_l = tuple(_where0(matched, y) for y in sys_)
    return key, out_l, tuple(out_r), matched, overflow
