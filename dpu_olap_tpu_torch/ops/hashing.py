"""Wang hash (counterpart of ``dpu_olap_tpu/ops/hashing.py:wang_hash``).

Behavioural parity with the reference's Wang hash,
dpu/shared/hashtable/hashtable.c:29-37 (HT_USE_WANG_HASH=1). The radix
bucket mapping arrives with the partition operator (ROADMAP §1 item 7).
"""

from __future__ import annotations

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
