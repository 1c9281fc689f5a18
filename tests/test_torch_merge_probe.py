"""Parity of the port's merge-probe (dpu_olap_tpu_torch.ops.merge_cuda, CPU
path) with the JAX package's Pallas kernel merge_probe_pallas in interpret
mode, on tests/test_merge_pallas.py's shapes and the edge cases: repeated,
absent and below-range probe keys, EMPTY tails on both sides, 0 and 3
payloads. Exact equality on every lane; the Pallas wrapper pads the build
side with (EMPTY, 0) rows to its block, so where a probe key is EMPTY the
port is held to it on a build side of whole blocks, or padded the same way
(ops/merge_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops.merge_pallas import merge_probe_pallas
from dpu_olap_tpu_torch.ops import merge_cuda
from dpu_olap_tpu_torch.ops.merge_cuda import merge_probe

R = 16  # small Pallas blocks: more boundary crossings per input
BLK = R * 128
EMPTY = np.uint32(0xFFFFFFFF)


def _port(left, right, pays):
    t = torch.from_numpy
    has, pkey, out = merge_probe(t(left), t(right), tuple(map(t, pays)))
    assert has.dtype == torch.bool and pkey.dtype == torch.uint32
    return has.numpy(), pkey.numpy(), [o.numpy() for o in out]


def _pallas(left, right, pays):
    has, pkey, out = merge_probe_pallas(
        jnp.asarray(left), jnp.asarray(right), tuple(map(jnp.asarray, pays)),
        block_rows=R, interpret=True,
    )
    return np.asarray(has), np.asarray(pkey), [np.asarray(o) for o in out]


def _oracle(left, right, pays):
    j = np.searchsorted(right, left, side="right") - 1
    has = j >= 0
    s = np.clip(j, 0, None)
    if right.size == 0:
        return has, np.full(left.size, EMPTY), [np.zeros(left.size, np.uint32) for _ in pays]
    return (has, np.where(has, right[s], EMPTY).astype(np.uint32),
            [np.where(has, p[s], 0).astype(np.uint32) for p in pays])


def _equal(a, b, lanes=slice(None)):
    np.testing.assert_array_equal(a[0][lanes], b[0][lanes])
    np.testing.assert_array_equal(a[1][lanes], b[1][lanes])
    assert len(a[2]) == len(b[2])
    for x, y in zip(a[2], b[2]):
        np.testing.assert_array_equal(x[lanes], y[lanes])


def _case(rng, nl, nr, n_pay=1, key_hi=2**31):
    right = np.sort(rng.choice(key_hi, size=nr, replace=False).astype(np.uint32))
    pays = [rng.integers(0, 2**32, nr, dtype=np.uint32) for _ in range(n_pay)]
    left = np.sort(rng.integers(0, key_hi, nl).astype(np.uint32))
    return left, right, pays


@pytest.mark.parametrize("nl, nr", [
    (BLK, BLK), (2 * BLK, BLK), (BLK, 2 * BLK), (4 * BLK, 4 * BLK),
    (3 * BLK - 77, 2 * BLK - 13),  # ragged: the Pallas padding paths
])
def test_merge_probe_matches_pallas(rng, nl, nr):
    left, right, pays = _case(rng, nl, nr)
    got = _port(left, right, pays)
    _equal(got, _pallas(left, right, pays))
    _equal(got, _oracle(left, right, pays))


@pytest.mark.parametrize("n_pay", [0, 3])
def test_merge_probe_payload_counts_match_pallas(rng, n_pay):
    left, right, pays = _case(rng, 2 * BLK - 5, BLK + 9, n_pay)
    _equal(_port(left, right, pays), _pallas(left, right, pays))


def test_merge_probe_repeated_and_absent_keys_match_pallas(rng):
    right = np.sort(rng.choice(2**31, size=2 * BLK, replace=False).astype(np.uint32))
    pays = [rng.integers(0, 2**32, right.size, dtype=np.uint32)]
    present = right[rng.integers(0, right.size, 3 * BLK)]  # runs of equal keys
    absent = rng.integers(0, 2**31, BLK).astype(np.uint32)
    left = np.sort(np.concatenate([present, absent]))
    got = _port(left, right, pays)
    _equal(got, _pallas(left, right, pays))
    hit = np.isin(left, right)
    assert np.array_equal(got[1][hit], left[hit]) and got[0][hit].all()


def test_merge_probe_below_every_build_key_matches_pallas():
    right = np.arange(1000, 1000 + BLK, dtype=np.uint32)
    left = np.arange(BLK, dtype=np.uint32)
    pays = [right ^ np.uint32(0x5A5A5A5A)]
    got = _port(left, right, pays)
    _equal(got, _pallas(left, right, pays))
    assert not got[0][:1000].any() and np.all(got[1][:1000] == EMPTY)
    assert not got[2][0][:1000].any()


@pytest.mark.parametrize("nr", [2 * BLK, 2 * BLK - 300])
def test_merge_probe_empty_tails_match_pallas(rng, nr):
    """EMPTY tails on both sides (the padded probe of _probe_sorted_stream,
    the invalid lanes of ht_build_sorted)."""
    left, right, pays = _case(rng, 3 * BLK - 40, nr, 2)
    left[-200:] = EMPTY
    right[-100:] = EMPTY
    expect = _pallas(left, right, pays)
    got = _port(left, right, pays)
    real = left != EMPTY
    _equal(got, expect, real)
    if nr % BLK == 0:
        _equal(got, expect)
    # the Pallas wrapper's (EMPTY, 0) block padding, given to the port
    pad = (-nr) % BLK
    padded = _port(left, np.concatenate([right, np.full(pad, EMPTY)]),
                   [np.concatenate([p, np.zeros(pad, np.uint32)]) for p in pays])
    _equal(padded, expect)


def test_merge_probe_empty_build_side(rng):
    left = np.sort(rng.integers(0, 2**32, 1000, dtype=np.uint32))
    right = np.zeros(0, np.uint32)
    pays = [np.zeros(0, np.uint32)]
    got = _port(left, right, pays)
    _equal(got, _oracle(left, right, pays))
    assert not got[0].any() and np.all(got[1] == EMPTY)


def test_merge_probe_rejects_bad_input():
    k = torch.zeros(4, dtype=torch.uint32)
    for bad, match in [
        (lambda: merge_probe(k.view(torch.int32), k), "uint32"),
        (lambda: merge_probe(k, k, (torch.zeros(3, dtype=torch.uint32),)), "length"),
        (lambda: merge_probe(k, k, (k,) * 9), "at most 8"),
        (lambda: merge_probe(torch.zeros(4, dtype=torch.uint32, device="meta"),
                             torch.zeros(4, dtype=torch.uint32, device="meta")), "cuda or cpu"),
        (lambda: merge_probe(k, torch.empty(1 << 32, dtype=torch.uint32, device="meta")), "2\\^32"),
    ]:
        with pytest.raises(ValueError, match=match):
            bad()
    before = merge_cuda.LAUNCHES
    merge_probe(k, k, (k,))
    assert merge_cuda.LAUNCHES == before  # the CPU path launches nothing



@pytest.mark.parametrize("where", ["below", "above"])
def test_merge_probe_probe_outside_the_build_range_matches_pallas(rng, where):
    """Every probe key below every build key (no hit), or above every one
    (all on the last build row)."""
    _, right, pays = _case(rng, 0, BLK, n_pay=2, key_hi=2**30)
    right = right + np.uint32(1000)
    left = (np.sort(rng.integers(0, 1000, 3000)) if where == "below"
            else np.sort(rng.integers(2**31, 2**32 - 1, 3000))).astype(np.uint32)
    got = _port(left, right, pays)
    _equal(got, _pallas(left, right, pays))
    _equal(got, _oracle(left, right, pays))
    assert got[0].all() == (where == "above") and got[0].any() == (where == "above")


def test_merge_probe_equal_run_across_a_tile_edge_matches_pallas(rng):
    """A run of equal probe keys that spans the kernel's tile edges (every
    TILE probe keys), present and absent in the build side."""
    _, right, pays = _case(rng, 0, BLK, n_pay=1)
    t = merge_cuda.TILE
    left = np.sort(np.concatenate([
        rng.integers(0, 2**31, t - 100).astype(np.uint32),
        np.full(300, right[BLK // 2], np.uint32),  # present, over the first edge
        np.full(t, right[BLK // 3] + np.uint32(1), np.uint32),  # absent, a whole tile and more
    ]))
    got = _port(left, right, pays)
    _equal(got, _pallas(left, right, pays))
    _equal(got, _oracle(left, right, pays))


@pytest.mark.parametrize("nl, nr", [(1, 1 << 16), (1 << 14, 7), (1000, 1 << 16), (5, 1)])
def test_merge_probe_sparse_and_dense_probes_match_pallas(rng, nl, nr):
    """One probe key against a whole build side, a probe much denser than
    the build side, one much sparser (its tiles reach past STAGE build
    keys), and a one-key build side."""
    left, right, pays = _case(rng, nl, nr)
    got = _port(left, right, pays)
    _equal(got, _oracle(left, right, pays))
    if nr % BLK == 0:  # the Pallas wrapper pads a partial build block
        _equal(got, _pallas(left, right, pays))


def test_merge_probe_unsorted_probe_matches_oracle(rng):
    """The contract asks for a sorted probe; an unsorted one still gets each
    key's own answer (the kernel searches the whole build side for a key
    outside its tile's first and last key)."""
    left, right, pays = _case(rng, 3000, 5000, n_pay=1)
    left = rng.permutation(left)
    _equal(_port(left, right, pays), _oracle(left, right, pays))
