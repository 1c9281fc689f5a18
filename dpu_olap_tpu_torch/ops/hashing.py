"""Hash functions and radix bucket mapping (counterpart of
``dpu_olap_tpu/ops/hashing.py``).

Behavioural parity with the reference:
  * Wang hash — dpu/shared/kernels/partition.c:20-28 and
    dpu/shared/hashtable/hashtable.c:29-37 (HT_USE_WANG_HASH=1).
  * Radix bucket — bucket = wang_hash(x) >> (1 + clz(nr_partitions)), the
    top log2(nr_partitions) bits of the hash (partition.c:44-49,
    USE_RADIX_PARTITIONING=1 in shared/umq/cflags.h:28-30). The partition
    kernel (csrc/partition.cu) computes the same bucket.
"""

from __future__ import annotations

import numpy as np
import torch

_M = 0xFFFFFFFF


def wang_hash(key: torch.Tensor) -> torch.Tensor:
    """Wang's 32-bit integer mix with exact uint32 wraparound: computed in
    int64 (every intermediate stays below 2^48) and masked to 32 bits after
    each step. Takes any integer tensor (read as uint32), returns uint32."""
    k = key.to(torch.int64) & _M
    k = (k + (~(k << 15) & _M)) & _M
    k = k ^ (k >> 10)
    k = (k + (k << 3)) & _M
    k = k ^ (k >> 6)
    k = (k + (~(k << 11) & _M)) & _M
    k = k ^ (k >> 16)
    return k.to(torch.uint32)


def bucket_shift(nr_partitions: int) -> int:
    """1 + clz(n): shift so the hash's top bits index one of n partitions.

    Matches BUCKET_SHIFT in partition.c:44 — for a power-of-two n this keeps
    exactly log2(n) top bits; for non-powers it over-shifts like the reference.
    """
    assert nr_partitions >= 1
    clz = 32 - int(nr_partitions).bit_length()
    return 1 + clz


def radix_bucket(keys: torch.Tensor, nr_partitions: int) -> torch.Tensor:
    """Partition id for each key (uint32): the top bits of the Wang hash."""
    if nr_partitions == 1:
        return torch.zeros(keys.shape, dtype=torch.uint32, device=keys.device)
    return (wang_hash(keys).to(torch.int64) >> bucket_shift(nr_partitions)).to(torch.uint32)


def wang_hash_np(key: np.ndarray) -> np.ndarray:
    """NumPy oracle of wang_hash (for tests and on-card checks)."""
    with np.errstate(over="ignore"):
        key = key.astype(np.uint32)
        key = key + ~(key << np.uint32(15))
        key = key ^ (key >> np.uint32(10))
        key = key + (key << np.uint32(3))
        key = key ^ (key >> np.uint32(6))
        key = key + ~(key << np.uint32(11))
        key = key ^ (key >> np.uint32(16))
        return key
