"""Cuckoo hash table (counterpart of ``dpu_olap_tpu/ops/hashtable.py:54-204``).

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
The sorted store (``ht_build_sorted`` and its probes) is ROADMAP §1 item 8.

The table's state is kept in int64 (uint32 values, EMPTY as 0xFFFFFFFF):
torch has no uint32 scatter on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hashing import wang_hash

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
