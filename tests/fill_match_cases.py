"""The packed-key cases of the co-sort joins' fill and match, shared by the
CPU tests (tests/test_torch_fill_match.py) and the on-card ones
(tests/test_torch_cuda_kernels.py). Imports no jax: the machine with the
card has none."""

import numpy as np

from dpu_olap_tpu_torch.ops.scan_cuda import EMPTY, TILE

KINDS = ["sorted", "run", "unsorted"]


def k2_case(kind: str, n: int, rng) -> np.ndarray:
    """Packed keys k2 = key << 1 | side (pk rows 0) of one case.

    sorted: a co-sort's order: fks below every pk, pk rows with 0-6 fks of
    their key, fks with no pk between them, then masked-out pk rows
    (0xFFFFFFFE) and pad or masked fk rows (0xFFFFFFFF). run: fks with no pk
    up to two lanes before the first tile's end, then one pk and its fks to
    the end, so its carry crosses every later tile. unsorted: keys drawn
    from the same kinds in no order, with 0 and 1."""
    if kind == "run":
        lead = min(n, TILE - 2)
        k2 = np.empty(n, np.int64)
        k2[:lead] = 2 * rng.integers(0, 1000, lead) + 1
        k2[lead:] = 2 * 5000 + 1
        if lead < n:
            k2[lead] = 2 * 5000
        return k2.astype(np.uint32)
    tail = n // 16
    body = n - 2 * tail
    pks = np.sort(100 + 3 * rng.choice((2**31 - 101) // 3, size=max(1, body // 4), replace=False))
    fks = np.concatenate([rng.choice(pks, size=body - body // 2),  # keys with a pk
                          rng.integers(0, 2**31 - 1, size=body // 2)])  # mostly none
    fks[: min(3, len(fks))] = rng.integers(0, 100, min(3, len(fks)))  # below every pk
    k2 = np.sort(np.concatenate([pks.astype(np.int64) << 1, (fks.astype(np.int64) << 1) | 1]))
    k2 = np.concatenate([k2[:body], np.full(tail, 0xFFFFFFFE), np.full(tail, EMPTY)])
    if kind == "unsorted":
        k2 = rng.permutation(k2)
        k2[: min(2, n)] = [0, 1][: min(2, n)]
    return k2.astype(np.uint32)
