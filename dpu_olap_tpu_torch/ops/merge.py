"""The bitonic merge, the sorted-build join and the dense-pk join
(counterpart of ``dpu_olap_tpu/ops/merge_xla.py``).

``bitonic_merge`` sorts a bitonic sequence of power-of-two length: the
merge-length cascade of ``bitonic_cuda.bitonic_merge_blocks``, whose kernel
runs the cross-block stages (``bitonic_xblock`` on the TPU) as one strided
pass and then the in-block cascade as one tile pass.

``join_shard_sorted_build`` joins a unique-pk build side that arrives sorted
(or is sorted once) with 31-bit keys: sort the probe side only, bitonic-merge
[ascending pk run | pad | descending fk run], then the forward fill and the
match mask, the tail that the fused co-sort join (ops/join.py) shares.

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

from ..metrics import trace
from . import hashtable
from .bitonic_cuda import LANES, bitonic_merge_blocks
from .scan_cuda import propagate_fill
from .sort_cuda import sort_bitonic, sortable_bitonic
from .take_cuda import gather_sorted

EMPTY = int(hashtable.EMPTY)  # the invalid-key and pad sentinel


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> uint32, wrapping modulo 2^32 like u32 arithmetic."""
    return (x & 0xFFFFFFFF).to(torch.uint32)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer column as uint32 (the JAX ``astype(uint32)``): the same
    bits for 4-byte integers, wrapped modulo 2^32 otherwise."""
    if x.dtype == torch.uint32:
        return x
    if x.dtype == torch.int32:
        return x.view(torch.uint32)
    return _u32(x.to(torch.int64))


def _where0(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x where mask, else 0, for a uint32 column."""
    return torch.where(mask, x.view(torch.int32), 0).view(torch.uint32)


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


def _fill(sk: torch.Tensor, is_pk: torch.Tensor, smerged, m_r: int) -> tuple:
    """The fill step of every co-sort join: sk (int64 keys, EMPTY for
    invalid lanes) sorted so that each pk row (is_pk; the others are fk
    rows) precedes its fk rows, smerged the payload planes that followed the
    sort. Each pk row's key and its m_r right payloads filled forward."""
    return propagate_fill((_u32(torch.where(is_pk, sk, EMPTY)), *smerged[:m_r]))


def _match(sk: torch.Tensor, is_pk: torch.Tensor, filled, smerged, m_l: int):
    """The match step after _fill, in the span dpu_olap.join.match: keep the
    fk rows whose filled key is their own, and zero the rest. Returns (key,
    out_l, out_r, matched)."""
    with trace("dpu_olap.join.match"):
        pkey = filled[0].to(torch.int64)
        matched = (pkey != EMPTY) & (pkey == sk) & ~is_pk & (sk != EMPTY)
        out_l = tuple(_where0(matched, smerged[k]) for k in range(m_l))
        out_r = tuple(_where0(matched, c) for c in filled[1:])
        return _u32(torch.where(matched, sk, 0)), out_l, out_r, matched


def _fill_match(sk: torch.Tensor, is_pk: torch.Tensor, smerged, m_l: int, m_r: int):
    """The tail of every co-sort join: _fill (in the span
    dpu_olap.join.fill), then _match."""
    with trace("dpu_olap.join.fill"):
        filled = _fill(sk, is_pk, smerged, m_r)
    return _match(sk, is_pk, filled, smerged, m_l)


def _decode_k2(sk2: torch.Tensor) -> tuple:
    """(sk, is_pk) of sorted packed keys k2 = key << 1 | side (side 0 for a
    pk row): k2 >= 0xFFFFFFFE decodes back to EMPTY."""
    k2 = sk2.to(torch.int64)
    return torch.where(k2 >= 0xFFFFFFFE, EMPTY, k2 >> 1), (k2 & 1) == 0


def fill_k2(planes, m_r: int) -> tuple:
    """The fill step of the co-sort joins with keys31, in the span
    dpu_olap.join.fill, on sorted planes (k2, payload 0, ...): (sk, is_pk,
    filled), the decoded keys and sides and each pk row's key and first m_r
    payloads filled forward."""
    with trace("dpu_olap.join.fill"):
        sk, is_pk = _decode_k2(planes[0])
        return sk, is_pk, _fill(sk, is_pk, planes[1:], m_r)


def _fill_match_k2(planes, m_l: int, m_r: int):
    """_fill_match for sorted planes led by packed keys (fill_k2)."""
    sk, is_pk, filled = fill_k2(planes, m_r)
    return _match(sk, is_pk, filled, planes[1:], m_l)


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
        merged = bitonic_merge((zk, *zps))
    return _fill_match_k2(merged, m_l, m_r)


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
