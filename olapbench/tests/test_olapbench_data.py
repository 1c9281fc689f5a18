"""The generator's rules and determinism, and the plain reference against a
join worked by hand."""

import torch

from olapbench.data.bm_join import block_seed, build_block, probe_block, probe_owner, rows
from olapbench.reference import join as ref

BIG_SEED = 2**31 + 987654321  # seeds run past 32 signed bits


def block(seed, blk, batches=3, batch_rows=1024):
    cfg = {"batches_per_chip": batches, "batch_rows": batch_rows}
    return (*probe_block(seed, blk, cfg, "cpu"), *build_block(seed, blk, cfg, "cpu"))


def test_same_seed_same_bytes_other_seed_other_bytes():
    a, b, c = block(BIG_SEED, 1), block(BIG_SEED, 1), block(BIG_SEED + 1, 1)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    fk, y, pk, x = a
    assert not torch.equal(fk, c[0]) and not torch.equal(y, c[1]) and not torch.equal(x, c[3])
    assert not torch.equal(y, x)  # the sides draw apart
    assert len({block_seed(BIG_SEED, s, b) for s in ("probe", "build") for b in (0, 1)}) == 4


def test_bm_join_rules():
    batch, batches, block_index = 512, 4, 2
    cfg = {"batches_per_chip": batches, "batch_rows": batch}
    n = batch * batches
    assert rows(cfg) == (n, n)
    cols = block(7, block_index, batches, batch)
    assert all(c.dtype == torch.uint32 and c.shape == (n,) for c in cols)
    first = block_index * n
    assert torch.equal(ref.widen(cols[2]), torch.arange(first, first + n))
    fk = ref.widen(cols[0])
    lo = first + (torch.arange(n) // batch) * batch
    assert bool(((fk >= lo) & (fk < lo + batch)).all())
    assert bool((probe_owner(fk, cfg) == block_index).all())
    # every probe row finds its pk in the build block of the same index
    assert ref.join(*cols)[0].shape[0] == n


def u32(values):
    """uint32 values in [0, 2^32) as a uint32 tensor."""
    return torch.tensor([v - (v >> 31 << 32) for v in values], dtype=torch.int32).view(torch.uint32)


def test_reference_against_a_join_by_hand():
    # build side unsorted, with a key of 2^32 - 1; probe side with a key
    # that has no pk and a repeated key
    pk, x = u32([9, 4, 0xFFFFFFFF, 7]), u32([90, 40, 0xAB, 70])
    fk, y = u32([4, 5, 9, 4, 0xFFFFFFFF]), u32([1, 2, 3, 4, 5])
    got = ref.join(fk, y, pk, x)
    want = [(4, 1, 40), (9, 3, 90), (4, 4, 40), (0xFFFFFFFF, 5, 0xAB)]
    assert list(zip(*(c.tolist() for c in got))) == want
    assert ref.exact_sum(got[2]) == 40 + 90 + 40 + 0xAB
    assert ref.rows_wrong(got, tuple(c.flip(0) for c in got)) == 0


def test_exact_sum_and_its_32_bit_control():
    x = torch.full((5,), 0xFFFFFFFF, dtype=torch.int64)
    assert ref.exact_sum(x) == 5 * 0xFFFFFFFF
    assert ref.sum_32(x) == (5 * 0xFFFFFFFF) & 0xFFFFFFFF != ref.exact_sum(x)


def test_rows_wrong_counts_missing_extra_and_altered_rows():
    rows = tuple(torch.tensor(v) for v in ([1, 2, 3], [10, 20, 30], [5, 6, 7]))
    assert ref.rows_wrong(rows, rows) == 0
    assert ref.rows_wrong(tuple(c[:2] for c in rows), rows) >= 1
    assert ref.rows_wrong(tuple(torch.cat([c, c[:1]]) for c in rows), rows) >= 1
    altered = (rows[0], rows[1], torch.tensor([5, 6, 8]))
    assert ref.rows_wrong(altered, rows) == 1
