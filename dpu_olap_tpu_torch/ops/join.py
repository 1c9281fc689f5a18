"""Single-shard PK/FK inner join (counterpart of ``dpu_olap_tpu/ops/join.py``).

  * ``join_shard_fused`` — the co-sort join: sort the concatenation of both
    sides so that every pk row precedes its fk rows, forward-fill the pk's
    key and payloads (scan_cuda.propagate_fill) and keep the fk rows whose
    filled key is their own. Rows come back key-sorted and padded to
    n_l + n_r with a ``matched`` mask. Under ``keys31`` the side packs into
    the key (k2 = key << 1 | side) and the ported bitonic sort runs;
    otherwise a stable sort keeps pk before equal fk.
  * ``join_shard_auto`` — the sorted-build join (merge.py) for a sorted pk
    with 31-bit keys, the fused join otherwise.
  * ``join_shard`` / ``probe_indices`` — one output row per left row in left
    order, with the "cosort" (co-sort + fill + restore sort), "cuckoo"
    (hashtable.py) or "sort" (sort + searchsorted) probe: the per-partition
    join of the shuffle join for a non-default ``impl``
    (parallel/dist_join.join_shuffled, ``JoinGpu(impl=...)``).

The stable multi-key sorts (the generic fused path, ``_cosort_probe``) are
``jax.lax.sort`` in the JAX package, an XLA sort and not a Pallas kernel;
their counterpart here is ``torch.sort(stable=True)`` on the key widened to
int64 (``sort_cuda.sort_bitonic_ref``), not the port of a kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..metrics import trace
from .hashtable import ht_build, ht_probe, table_capacity
from .merge import (
    EMPTY,
    _as_u32,
    _fill_match,
    _match,
    _sort,
    _u32,
    fill_k2,
    join_shard_sorted_build,
)
from .scan_cuda import propagate_fill
from .sort_cuda import sort_bitonic_ref


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def _check_32bit_payloads(*payload_tuples):
    """The fused joins carry payloads as uint32 sort operands; 64-bit or
    float payloads would lose bits. {u,}int32 move exactly; anything else
    fails loudly (join_shard keeps dtypes instead)."""
    for cols in payload_tuples:
        for c in cols:
            if c.dtype not in (torch.int32, torch.uint32):
                raise TypeError(
                    f"fused join payloads must be 32-bit integers, got {c.dtype}; "
                    "use join_shard(impl=...) for other payload dtypes"
                )


def _masked_key(key: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """A key column as uint32, EMPTY where not valid."""
    k = _as_u32(key)
    if valid is None:
        return k
    return torch.where(valid, k.view(torch.int32), -1).view(torch.uint32)


def _cosort_probe(left_fk, right_pk, right_valid, left_valid):
    """(selection, found) in LEFT row order via co-sort + fill + restore sort."""
    n_r, n_l = right_pk.shape[0], left_fk.shape[0]
    dev = left_fk.device
    keys = torch.cat([_masked_key(right_pk, right_valid), _masked_key(left_fk, left_valid)])
    keys = keys.to(torch.int64)
    side = torch.cat([torch.zeros(n_r, dtype=torch.int64, device=dev),
                      torch.ones(n_l, dtype=torch.int64, device=dev)])
    rowid = torch.cat([torch.arange(n_r, device=dev), torch.arange(n_l, device=dev)])
    # sort by (key, side): the two sort keys packed into one int64
    order = torch.sort(keys * 2 + side, stable=True).indices
    sk, sside, srow = keys[order], side[order], rowid[order]
    pkey, prow = propagate_fill((_u32(torch.where(sside == 0, sk, EMPTY)), _u32(srow)))
    pkey = pkey.to(torch.int64)
    found_sorted = (pkey != EMPTY) & (pkey == sk) & (sside == 1) & (sk != EMPTY)
    # restore probe-side order: sort by original left row (pk rows to the end)
    left_pos = torch.where(sside == 1, srow, n_l)
    restore = torch.sort(left_pos, stable=True).indices[:n_l]
    return prow.to(torch.int64)[restore], found_sorted[restore]


def _cosort_planes(left_fk, left_payload, right_pk, right_payload, left_valid, right_valid):
    """The fused join's sort operands: the masked keys (pk, fk) and the
    merged payload planes, right rows first (payload k of both sides in one
    plane, zeros where a side has fewer)."""
    _check_32bit_payloads(left_payload, right_payload)
    n_r, n_l = right_pk.shape[0], left_fk.shape[0]
    m_l, m_r = len(left_payload), len(right_payload)
    dev = left_fk.device
    zeros_r = torch.zeros(n_r, dtype=torch.uint32, device=dev)
    zeros_l = torch.zeros(n_l, dtype=torch.uint32, device=dev)
    merged = [
        torch.cat([_as_u32(right_payload[k]) if k < m_r else zeros_r,
                   _as_u32(left_payload[k]) if k < m_l else zeros_l])
        for k in range(max(m_l, m_r))
    ]
    return _masked_key(right_pk, right_valid), _masked_key(left_fk, left_valid), merged


def cosort_k2(left_fk, left_payload, right_pk, right_payload, left_valid=None,
              right_valid=None) -> tuple:
    """The sort step of join_shard_fused with keys31, in the span
    dpu_olap.join.sort: the side packed into the key, k2 = key << 1 | side
    (pk rows 0), sorted with the merged payload planes. Returns the sorted
    planes (k2, payload 0, ...)."""
    with trace("dpu_olap.join.sort"):
        pk, fk, merged = _cosort_planes(left_fk, left_payload, right_pk, right_payload,
                                        left_valid, right_valid)
        # EMPTY maps to 0xFFFFFFFE/0xFFFFFFFF: still the maximum
        k2 = _u32(torch.cat([pk.to(torch.int64) << 1, (fk.to(torch.int64) << 1) | 1]))
        return _sort((k2, *merged))


def join_shard_fused(
    left_fk: torch.Tensor,
    left_payload: Tuple[torch.Tensor, ...],
    right_pk: torch.Tensor,
    right_payload: Tuple[torch.Tensor, ...],
    left_valid: torch.Tensor | None = None,
    right_valid: torch.Tensor | None = None,
    keys31: bool = False,
):
    """Fully fused co-sort join: payload columns ride the sort and the fill,
    so there are no gathers. Returns (key, left_cols, right_cols, matched),
    each of length n_l + n_r, key-sorted and padded with the ``matched``
    mask; payload k of both sides shares one sort operand.

    keys31: all keys < 2^31 - 1, so the side packs into the sort key as
    k2 = key << 1 | side and stability no longer matters; k2 values >=
    0xFFFFFFFE decode back to EMPTY (which excludes 0x7FFFFFFF itself).
    Callers check the range on the host. Its steps are cosort_k2, fill_k2
    and the match (the spans dpu_olap.join.sort, .fill and .match)."""
    m_l, m_r = len(left_payload), len(right_payload)
    if keys31:
        planes = cosort_k2(left_fk, left_payload, right_pk, right_payload, left_valid,
                           right_valid)
        sk, is_pk, filled = fill_k2(planes, m_r)
        return _match(sk, is_pk, filled, planes[1:], m_l)
    with trace("dpu_olap.join.sort"):
        pk, fk, merged = _cosort_planes(left_fk, left_payload, right_pk, right_payload,
                                        left_valid, right_valid)
        # the stable sort keeps each pk row before its equal fk rows; side
        # rides as an operand
        dev = left_fk.device
        side = torch.cat([torch.zeros(pk.shape[0], dtype=torch.uint32, device=dev),
                          torch.ones(fk.shape[0], dtype=torch.uint32, device=dev)])
        sk, sside, *smerged = sort_bitonic_ref((torch.cat([pk, fk]), side, *merged))
    return _fill_match(sk.to(torch.int64), sside.view(torch.int32) == 0, smerged, m_l, m_r)


def join_shard_auto(
    left_fk,
    left_payload,
    right_pk,
    right_payload,
    keys31: bool = False,
    pk_sorted: bool = False,
):
    """Single-shard join with host-detected workload structure:
    pk_sorted and keys31 -> the sorted-build bitonic-merge join (merge.py);
    keys31 -> the fused join with the side packed into the key; otherwise
    the generic fused join."""
    if pk_sorted and keys31:
        return join_shard_sorted_build(left_fk, left_payload, right_pk, right_payload)
    return join_shard_fused(left_fk, left_payload, right_pk, right_payload, keys31=keys31)


def probe_indices(
    left_fk: torch.Tensor,
    right_pk: torch.Tensor,
    right_valid: torch.Tensor | None = None,
    left_valid: torch.Tensor | None = None,
    impl: str = "cosort",
):
    """For each left row, the right row index holding its pk (the
    selection_indices_vector of hash_probe.c) plus a found mask. The
    selection is int64 here (uint32 in the JAX package); it is meaningful
    only where found."""
    n_right = right_pk.shape[0]
    if impl == "cosort":
        return _cosort_probe(left_fk, right_pk, right_valid, left_valid)
    if impl == "cuckoo":
        cap = table_capacity(n_right)
        rows = torch.arange(n_right, device=right_pk.device)
        table = ht_build(right_pk, rows, cap, valid=right_valid)
        sel, found = ht_probe(table, left_fk)
        sel = sel.to(torch.int64)
        # a build that did not converge has dropped keys: an empty result
        # instead of partially wrong matches (hash_build.c:31 asserts it)
        found = found & table.ok
    elif impl == "sort":
        pk = _masked_key(right_pk, right_valid).to(torch.int64)  # invalid to the end
        pk_sorted, order = torch.sort(pk, stable=True)
        fk = _as_u32(left_fk).to(torch.int64)
        pos = torch.searchsorted(pk_sorted, fk).clamp(max=n_right - 1)
        found = pk_sorted[pos] == fk
        sel = order[pos]
    else:
        raise ValueError(f"unknown join impl {impl!r}")
    if left_valid is not None:
        found = found & left_valid
    return sel, found


def join_shard(
    left_fk: torch.Tensor,
    left_payload: Tuple[torch.Tensor, ...],
    right_pk: torch.Tensor,
    right_payload: Tuple[torch.Tensor, ...],
    left_valid: torch.Tensor | None = None,
    right_valid: torch.Tensor | None = None,
    impl: str = "cosort",
):
    """Inner join of one co-partitioned shard pair.

    Returns (fk, left_payload, right_payload_gathered, matched) with one
    output row per left row, left order kept; right columns keep their
    dtype and are 0 where unmatched."""
    sel, found = probe_indices(
        left_fk, right_pk, right_valid=right_valid, left_valid=left_valid, impl=impl
    )
    safe = torch.where(found, sel, 0)
    right_cols = []
    for col in right_payload:
        # unsigned columns move as their signed bits: torch has no unsigned
        # index or where on the card
        bits = col.view(_SIGNED.get(col.dtype, col.dtype))[safe]
        zero = torch.zeros((), dtype=bits.dtype, device=bits.device)
        right_cols.append(torch.where(found, bits, zero).view(col.dtype))
    return left_fk, left_payload, tuple(right_cols), found


def join_result_to_numpy(fk, left_cols, right_cols, matched):
    """Compact a padded join shard result to host numpy arrays (valid rows
    only) — the host-side 'build result' stage (join_dpu.cc:371-399)."""
    m = matched.cpu().numpy()
    out = [fk.cpu().numpy()[m]]
    out += [c.cpu().numpy()[m] for c in left_cols]
    out += [c.cpu().numpy()[m] for c in right_cols]
    return out
