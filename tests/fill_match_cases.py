"""The packed-key cases of the co-sort joins' fill and match, shared by the
CPU tests (tests/test_torch_fill_match.py) and the on-card ones
(tests/test_torch_cuda_kernels.py). Imports no jax: the machine with the
card has none."""

import numpy as np

from dpu_olap_tpu_torch.ops.scan_cuda import EMPTY, TILE

KINDS = ["sorted", "run", "unsorted", "none", "all", "dead"]


def k2_case(kind: str, n: int, rng) -> np.ndarray:
    """Packed keys k2 = key << 1 | side (pk rows 0) of one case.

    sorted: a co-sort's order: fks below every pk, pk rows with 0-6 fks of
    their key, fks with no pk between them, then masked-out pk rows
    (0xFFFFFFFE) and pad or masked fk rows (0xFFFFFFFF). run: fks with no pk
    up to two lanes before the first tile's end, then one pk and its fks to
    the end, so its carry crosses every later tile. unsorted: keys drawn
    from the same kinds in no order, with 0 and 1. none: pks (keys 3i) and
    fks (keys 3j + 1) in order, no fk with its pk. all: each pk followed by
    1-3 fks of its key, every fk matched. dead: stretches of lanes with no
    match, each about a fifth of n (several tiles at the longer lengths):
    fks below every pk, a pk and its fks, a pk and fks with no pk above it,
    masked-out pk rows, then pad rows."""
    if kind == "none":
        n_pk = n // 3
        pk = 6 * rng.choice(n, size=n_pk, replace=False)
        fk = 2 * (3 * rng.integers(0, n, n - n_pk) + 1) + 1
        return np.sort(np.concatenate([pk, fk])).astype(np.uint32)
    if kind == "all":
        fks = rng.integers(1, 4, n)  # fks a pk
        keys = np.repeat(np.arange(n), fks + 1)[:n]
        first = np.concatenate([[True], keys[1:] != keys[:-1]])
        return np.where(first, 2 * keys, 2 * keys + 1).astype(np.uint32)
    if kind == "dead":
        cut = [n // 5, 2 * n // 5, 3 * n // 5, 4 * n // 5]
        k2 = np.empty(n, np.int64)
        k2[:cut[0]] = np.sort(2 * rng.integers(0, 100, cut[0]) + 1)
        k2[cut[0]:cut[1]] = 2 * 200 + 1
        k2[cut[1]:cut[2]] = np.sort(2 * (300 + rng.integers(1, 10**6, cut[2] - cut[1])) + 1)
        k2[cut[1]:cut[2]][:1] = 2 * 300
        k2[cut[0]:cut[1]][:1] = 2 * 200
        k2[cut[2]:cut[3]] = 0xFFFFFFFE
        k2[cut[3]:] = 0xFFFFFFFF
        return k2.astype(np.uint32)
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
