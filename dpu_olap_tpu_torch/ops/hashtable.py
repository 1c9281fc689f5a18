"""Hash tables (counterpart of ``dpu_olap_tpu/ops/hashtable.py``): the cuckoo
table (:54-204) and the sorted store (:229-377).

The d-ary cuckoo table of the JAX package, in plain PyTorch: each key has
d = 3 candidate slots from independent multiply-shift mixes of its Wang hash
(hashing.py); insertion is a fixed point of whole-array gather/scatter
rounds (a winner that displaced an occupant adopts it as its new pending
entry, losers retry with their next way), and the probe gathers the d
candidate slots. It serves ``join.probe_indices(impl="cuckoo")``, the
parity component of the reference's MRAM hash table
(dpu/shared/hashtable/hashtable.{h,c}); the JAX package computes it outside
Pallas too. When several lanes scatter to one slot, one arbitrary lane wins
(on the CPU and on the card alike), so two builds of the same keys may lay
the table out differently; lookups (values, found) and convergence (ok)
agree. Keys must be unique; 0xFFFFFFFF is reserved as the EMPTY sentinel.

The sorted store, the JAX package's default table, is the sorted (key,
value) array itself: ``ht_build_sorted`` is one sort (the ported bitonic
sort, sort_cuda.py), and a probe sorts the queries with their positions,
runs one merge-probe over the store (merge_cuda.py) and, for
``ht_probe_sorted``, sorts back by position with ``found`` packed into the
restore key's bit 0. On the CPU the same algorithm runs over the plain
versions of the two kernels.

The table's state is kept in int64 (uint32 values, EMPTY as 0xFFFFFFFF):
torch has no uint32 scatter on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hashing import wang_hash
from .sort_cuda import sort_bitonic, sortable_bitonic

# Reserved key: the EMPTY slot marker and the sort pad key. Real keys equal
# to it are outside the fast paths' contract.
EMPTY = np.uint32(0xFFFFFFFF)
_EMPTY = int(EMPTY)

# Odd multipliers for the d multiply-shift mixes (Knuth/Fibonacci-style).
_MIXERS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


def next_pow2(n: int) -> int:
    return 1 << max(1, (int(n) - 1).bit_length())


def table_capacity(n_keys: int, load_factor: float = 0.5) -> int:
    """Slots for n keys (reference sizes 4Mi slots for 2Mi keys,
    dpu/join/main.c:29 — load factor 0.5)."""
    return next_pow2(int(np.ceil(n_keys / load_factor)))


def _mul_u32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h < 2^32 and an int m < 2^32, with every
    partial product below 2^48."""
    return (h * (m & 0xFFFF) + (((h * (m >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _slot(key: torch.Tensor, way: torch.Tensor, log2_cap: int) -> torch.Tensor:
    """way-th candidate slot (int64): multiply-shift over the Wang-mixed
    key; ``way`` is an int64 tensor of values in [0, len(_MIXERS))."""
    h = wang_hash(key).to(torch.int64)
    mixed = torch.zeros_like(h)
    for w, mult in enumerate(_MIXERS):
        mixed = torch.where(way == w, _mul_u32(h, mult), mixed)
    mixed = (mixed + way) & 0xFFFFFFFF
    return mixed >> (32 - log2_cap)


@dataclasses.dataclass
class HashTable:
    keys: torch.Tensor  # uint32[capacity], EMPTY where unoccupied
    values: torch.Tensor  # uint32[capacity]
    ways: torch.Tensor  # uint32[capacity], which hash fn the occupant used
    ok: torch.Tensor  # bool scalar: build converged (reference assert(ok))
    rounds: torch.Tensor  # uint32 scalar: scatter/gather rounds used to build

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def stats(self) -> dict:
        """Build statistics (the HT_ENABLE_STATS analog, hashtable.h:40-48 —
        there: probe distance and slow-path counts; here: convergence rounds
        and occupancy)."""
        occupied = int((self.keys.to(torch.int64) != _EMPTY).sum())
        return {
            "capacity": self.capacity,
            "occupied": occupied,
            "load_factor": occupied / self.capacity,
            "build_rounds": int(self.rounds),
            "converged": bool(self.ok),
        }


def ht_build(
    keys: torch.Tensor,
    values: torch.Tensor,
    capacity: int,
    valid: torch.Tensor | None = None,
    n_ways: int = 3,
    max_rounds: int = 48,
) -> HashTable:
    """Build the table from unique uint32 keys (+ uint32 payload values).

    ``valid`` masks out padded lanes (shuffle fragments). Reference analog:
    kernel_hash_build's block loop of ht_put calls (hash_build.c:16-32)."""
    if capacity < 2 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two >= 2, got {capacity}")
    log2_cap = capacity.bit_length() - 1
    dev = keys.device
    n = keys.shape[0]
    pend_k = keys.to(torch.int64) & 0xFFFFFFFF
    pend_v = values.to(torch.int64) & 0xFFFFFFFF
    pend_w = torch.zeros(n, dtype=torch.int64, device=dev)
    table_k = torch.full((capacity,), _EMPTY, dtype=torch.int64, device=dev)
    table_v = torch.zeros(capacity, dtype=torch.int64, device=dev)
    table_w = torch.zeros(capacity, dtype=torch.int64, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid.to(torch.bool)
    active = active & (pend_k != _EMPTY)

    rounds = 0
    while rounds < max_rounds and bool(active.any()):
        lanes = active.nonzero().squeeze(1)
        k, v, w = pend_k[lanes], pend_v[lanes], pend_w[lanes]
        slot = _slot(k, w % n_ways, log2_cap)
        prev_k, prev_v, prev_w = table_k[slot], table_v[slot], table_w[slot]
        table_k[slot] = k  # one lane wins each contested slot
        won = table_k[slot] == k
        # winners have unique slots: value/way scatters cannot conflict
        table_v[slot[won]] = v[won]
        table_w[slot[won]] = w[won]
        # a winner that displaced a live occupant adopts it as its new
        # pending entry; the displaced key retries with its next way
        evicted = won & (prev_k != _EMPTY)
        pend_k[lanes] = torch.where(evicted, prev_k, k)
        pend_v[lanes] = torch.where(evicted, prev_v, v)
        pend_w[lanes] = torch.where(evicted, prev_w + 1, w + 1)
        active[lanes] = ~won | evicted
        rounds += 1

    return HashTable(
        keys=table_k.to(torch.uint32),
        values=table_v.to(torch.uint32),
        ways=table_w.to(torch.uint32),
        ok=~active.any(),
        rounds=torch.tensor(rounds, dtype=torch.uint32, device=dev),
    )


def ht_probe(table: HashTable, queries: torch.Tensor, n_ways: int = 3):
    """Look up each query key: returns (values uint32, found bool).

    Reference analog: kernel_hash_probe's per-element ht_get chain
    (hash_probe.c:29-40); here d gathers + compares, branch-free."""
    log2_cap = table.capacity.bit_length() - 1
    q = queries.to(torch.int64) & 0xFFFFFFFF
    tk = table.keys.to(torch.int64)
    tv = table.values.to(torch.int64)
    val = torch.zeros_like(q)
    found = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    for way in range(n_ways):
        slot = _slot(q, torch.full_like(q, way), log2_cap)
        k = tk[slot]
        hit = (k == q) & ~found
        val = torch.where(hit, tv[slot], val)
        found = found | (k == q)
    # the EMPTY sentinel marks unoccupied slots; it is never a real key
    found = found & (q != _EMPTY)
    return val.to(torch.uint32), found


# ---------------------------------------------------------------------------
# Sorted-store hash table (hashtable.py:229-377 of the JAX package): build =
# one sort of (keys, values); probe = sort (query, pos) -> merge-probe ->
# restore sort. Store keys must be unique (the reference's PK contract);
# queries may repeat. 0xFFFFFFFF stays the EMPTY/invalid sentinel.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SortedTable:
    keys: torch.Tensor  # uint32[n] ascending; EMPTY-padded tail for invalid
    values: torch.Tensor  # uint32[n]

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def stats(self) -> dict:
        occupied = int((self.keys.to(torch.int64) != _EMPTY).sum())
        return {
            "capacity": self.capacity,
            "occupied": occupied,
            "load_factor": occupied / max(1, self.capacity),
            "build_rounds": 1,
            "converged": True,
        }


def ht_build_sorted(
    keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor | None = None
) -> SortedTable:
    """Sort (keys, values) ascending; invalid lanes become the EMPTY tail.

    Load factor 1.0: no slack slots, no convergence loop, no overflow (the
    reference's assert(ok) at hash_build.c:31 cannot fire)."""
    from .merge import _as_u32  # merge imports this module

    k = _as_u32(keys)
    v = _as_u32(values)
    if valid is not None:
        k = torch.where(valid, k.view(torch.int32), -1).view(torch.uint32)
    if sortable_bitonic(k.shape[0]):
        k, v = sort_bitonic((k, v))
    return SortedTable(keys=k, values=v)


def _probe_sorted_stream(table: SortedTable, q: torch.Tensor):
    """The sort -> merge core for k >= 2 queries: (spos, pval, found_s) of
    length npow = next_pow2(k) in sorted-query order, spos each entry's
    original position. The queries are padded here to the sort's
    power-of-two length with EMPTY keys and the distinct positions k..npow-1:
    real queries may be EMPTY too, and the sort's own anonymous pads would
    interleave with them (hashtable.py:290-301)."""
    from .merge_cuda import merge_probe

    k = q.shape[0]
    dev = q.device
    npow = 1 << (k - 1).bit_length()
    q_p = q
    if npow != k:
        q_p = torch.cat([q, torch.full((npow - k,), -1, dtype=torch.int32, device=dev)
                         .view(torch.uint32)])
    pos_p = torch.arange(npow, device=dev).to(torch.uint32)
    sq, spos = sort_bitonic((q_p, pos_p))
    has, pkey, (pval,) = merge_probe(sq, table.keys, (table.values,))
    found_s = has & (pkey.view(torch.int32) == sq.view(torch.int32)) & (sq.to(torch.int64) != _EMPTY)
    return spos, pval, found_s


def _probe_one(table: SortedTable, q: torch.Tensor):
    """(values, found) for k < 2 queries: one merge-probe (a single query is
    sorted)."""
    from .merge_cuda import merge_probe

    has, pkey, (pval,) = merge_probe(q, table.keys, (table.values,))
    found = has & (pkey.view(torch.int32) == q.view(torch.int32)) & (q.to(torch.int64) != _EMPTY)
    return torch.where(found, pval.view(torch.int32), 0).view(torch.uint32), found


def ht_probe_sorted(table: SortedTable, queries: torch.Tensor):
    """(values, found) per query against a SortedTable, in query order."""
    from .merge import _as_u32

    q = _as_u32(queries)
    k = q.shape[0]
    if not sortable_bitonic(k):
        return _probe_one(table, q)
    spos, pval, found_s = _probe_sorted_stream(table, q)
    # the restore key packs found into bit 0: one payload plane, 2-op sort
    rk = (spos.to(torch.int64) << 1) | found_s.to(torch.int64)
    rk2, vout = sort_bitonic(((rk & 0xFFFFFFFF).to(torch.uint32), pval))
    found = (rk2[:k].to(torch.int64) & 1) == 1
    return torch.where(found, vout[:k].view(torch.int32), 0).view(torch.uint32), found


def ht_probe_sorted_stream(table: SortedTable, queries: torch.Tensor):
    """Order-free probe: (pos, values, found) in sorted-QUERY stream order,
    skipping ht_probe_sorted's restore sort. Every real query appears
    exactly once; pos is its original position. The arrays have length
    next_pow2(k): pad entries (only when k is not a power of two) carry
    pos >= k and found False. The stream order is unspecified by contract
    (hashtable.py:366-368): consumers key on pos."""
    from .merge import _as_u32

    q = _as_u32(queries)
    k = q.shape[0]
    if not sortable_bitonic(k):
        val, found = _probe_one(table, q)
        return torch.arange(k, device=q.device).to(torch.uint32), val, found
    spos, pval, found_s = _probe_sorted_stream(table, q)
    return spos, torch.where(found_s, pval.view(torch.int32), 0).view(torch.uint32), found_s


def _signed_view(x: torch.Tensor) -> torch.Tensor:
    """uint32 order mapped onto int32 order (x ^ 0x80000000 as int32), for
    searchsorted, which compares signed values."""
    return x.view(torch.int32) ^ -0x80000000
