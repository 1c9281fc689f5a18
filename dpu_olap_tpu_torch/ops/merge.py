"""The bitonic merge, the sorted-build join and the dense-pk join
(counterpart of ``dpu_olap_tpu/ops/merge_xla.py``).

``bitonic_merge`` sorts a bitonic sequence of power-of-two length: the
merge-length cascade of ``bitonic_cuda.bitonic_merge_blocks``, whose kernel
runs the cross-block stages (``bitonic_xblock`` on the TPU) as one strided
pass and then the in-block cascade as one tile pass.

``join_shard_sorted_build`` joins a unique-pk build side that arrives sorted
(or is sorted once) with 31-bit keys: sort the probe side only, bitonic-merge
[ascending pk run | pad | descending fk run] (``sorted_build_planes``), then
the forward fill and the match mask in one kernel (``fill_match``:
``fill_match_cuda.fill_match_k2``), the tail that the fused co-sort join with
keys31 (ops/join.py) shares. ``fill_match_compact`` is the tail with the
compaction of the matched rows in the same kernel
(``fill_match_compact_cuda.fill_match_compact_k2``), which the query plan's
device-resident join takes after either join's planes.

When the build side's pk is dense (pk[i] = pk[0] + i, checked on the host by
the operator; always true for the reference generator's sequential pk,
host/generator/generator.cc:59-71), ``join_shard_dense`` makes the probe a
positional lookup: sort the probe side by ``fk - pk0`` and gather each build
payload at the sorted positions.

uint32 glue arithmetic runs in int64 and narrows back with ``& 0xFFFFFFFF``,
which reproduces the JAX package's wrapping u32 arithmetic exactly; masking
and reversal move uint32 columns as int32 bit patterns.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..metrics import count, trace
from .bitonic_cuda import LANES, bitonic_merge_blocks
from .fill_match_compact_cuda import fill_match_compact_k2
from .fill_match_cuda import fill_match_k2
from .scan_cuda import EMPTY, _u32, _where0, fill_planes, match_filled, propagate_fill
from .sort_cuda import sort_bitonic, sortable_bitonic
from .take_cuda import gather_sorted


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer column as uint32 (the JAX ``astype(uint32)``): the same
    bits for 4-byte integers, wrapped modulo 2^32 otherwise."""
    if x.dtype == torch.uint32:
        return x
    if x.dtype == torch.int32:
        return x.view(torch.uint32)
    return _u32(x.to(torch.int64))


def _reverse(x: torch.Tensor) -> torch.Tensor:
    """A uint32 column reversed (torch has no uint32 flip on the CPU)."""
    return torch.flip(x.view(torch.int32), [0]).view(torch.uint32)


def bitonic_merge(planes) -> tuple:
    """Sort a BITONIC sequence (e.g. an ascending run followed by a
    descending one): planes[0] is the uint32 key, the others follow it.
    The length must be a power of two (callers pad with 0xFFFFFFFF keys).
    Below the merge kernel's smallest block (128) the ported sort finishes,
    as the TPU version's plain sort does below its block (test scale only)."""
    planes = tuple(planes)
    n = planes[0].shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"bitonic_merge needs a power-of-two length, got {n}")
    if n < LANES:
        return _sort(planes)
    return bitonic_merge_blocks(planes, block_rows=n // LANES)


def _fill_match(sk: torch.Tensor, is_pk: torch.Tensor, smerged, m_l: int, m_r: int):
    """The tail of the generic co-sort join (keys not all below 2^31 - 1):
    sk (int64 keys, EMPTY for invalid lanes) sorted so that each pk row
    (is_pk) precedes its fk rows, smerged the payload planes that followed
    the sort. The fill (propagate_fill, in the span dpu_olap.join.fill),
    then the match (in the span dpu_olap.join.match). Returns (key, out_l,
    out_r, matched)."""
    with trace("dpu_olap.join.fill"):
        filled = propagate_fill(fill_planes(sk, is_pk, smerged, m_r))
    with trace("dpu_olap.join.match"):
        return match_filled(sk, is_pk, filled, smerged, m_l)


def fill_match(planes, m_l: int, m_r: int):
    """The tail of the co-sort joins with keys31, in the span
    dpu_olap.join.fill_match and counted as join.fill_match: the fill and
    the match over sorted planes (k2, payload 0, ...) in one kernel
    (fill_match_cuda.fill_match_k2). Returns (key, out_l, out_r, matched)."""
    with trace("dpu_olap.join.fill_match"):
        count("join.fill_match")
        return fill_match_k2(planes, m_l, m_r)


def fill_match_compact(planes, m_l: int, m_r: int, capacity: int):
    """fill_match with the compaction of its matched rows in the same
    kernel (fill_match_compact_cuda.fill_match_compact_k2), in the span
    dpu_olap.join.fill_match and counted as join.fill_match_compact.
    Returns (key, out_l, out_r, count): ``capacity`` rows a plane, the
    matched rows first in key order, count a 0-d device tensor."""
    with trace("dpu_olap.join.fill_match"):
        count("join.fill_match_compact")
        return fill_match_compact_k2(planes, m_l, m_r, capacity)


def _sort(planes) -> tuple:
    """The ported bitonic sort; a single row is already sorted."""
    return sort_bitonic(planes) if sortable_bitonic(planes[0].shape[0]) else tuple(planes)


def join_shard_sorted_build(
    left_fk: torch.Tensor,
    left_payload: Tuple[torch.Tensor, ...],
    right_pk: torch.Tensor,
    right_payload: Tuple[torch.Tensor, ...],
    pk_sorted: bool = True,
):
    """Co-sort join for a SORTED (or, with pk_sorted=False, sorted-once)
    unique-pk build side with keys < 2^31 - 1. Returns (key, out_l, out_r,
    matched), each padded to the merge length (the next power of two of
    n_l + n_r), key-sorted; payload k of both sides shares one merged
    plane. The probe sort may permute the payloads of equal fks."""
    planes = sorted_build_planes(left_fk, left_payload, right_pk, right_payload, pk_sorted)
    return fill_match(planes, len(left_payload), len(right_payload))


def sorted_build_planes(
    left_fk: torch.Tensor,
    left_payload: Tuple[torch.Tensor, ...],
    right_pk: torch.Tensor,
    right_payload: Tuple[torch.Tensor, ...],
    pk_sorted: bool = True,
) -> tuple:
    """The steps of join_shard_sorted_build before its tail, in the spans
    dpu_olap.join.keys, .sort and .merge: the merged planes (k2, payload 0,
    ...), k2 = key << 1 | side (pk rows 0), sorted, padded to the merge
    length with 0xFFFFFFFF keys."""
    n_r, n_l = right_pk.shape[0], left_fk.shape[0]
    m_l, m_r = len(left_payload), len(right_payload)
    m = max(m_l, m_r)
    dev = left_fk.device
    with trace("dpu_olap.join.keys"):
        xs = [_as_u32(right_payload[k]) if k < m_r
              else torch.zeros(n_r, dtype=torch.uint32, device=dev) for k in range(m)]
        ys = [_as_u32(left_payload[k]) if k < m_l
              else torch.zeros(n_l, dtype=torch.uint32, device=dev) for k in range(m)]
        probe = (_u32((_as_u32(left_fk).to(torch.int64) << 1) | 1), *ys)
        k2_r = _u32(_as_u32(right_pk).to(torch.int64) << 1)
    with trace("dpu_olap.join.sort"):
        sorted_l = _sort(probe)
        del probe  # the packed probe keys, as soon as they are sorted
        if not pk_sorted:
            k2_r, *xs = _sort((k2_r, *xs))

    with trace("dpu_olap.join.merge"):
        n = n_r + n_l
        pad = (1 << (n - 1).bit_length()) - n
        # [ascending pk run | max-key pad | descending fk run] is bitonic
        zk = torch.cat([k2_r, torch.full((pad,), EMPTY, dtype=torch.uint32, device=dev),
                        _reverse(sorted_l[0])])
        zps = [torch.cat([x, torch.zeros(pad, dtype=torch.uint32, device=dev), _reverse(sy)])
               for x, sy in zip(xs, sorted_l[1:])]
        return bitonic_merge((zk, *zps))


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

    # 0 where unmatched: no mask needed. Every gather's flag is 0, so the
    # first one stands for all
    gathered = [gather_sorted(x, sidx) for x in right_payload]
    out_r = [val for val, _ in gathered]
    overflow = (gathered[0][1] if gathered
                else torch.zeros((), dtype=torch.int32, device=left_fk.device))

    key = _where0(matched, _u32(sidx64 + lo))
    out_l = tuple(_where0(matched, y) for y in sys_)
    return key, out_l, tuple(out_r), matched, overflow
