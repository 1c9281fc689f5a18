"""Parity of the port's sort (dpu_olap_tpu_torch.ops.sort_cuda) with the JAX
package's Pallas merge-tree sort, run in interpret mode on the CPU, and the
radix sort's launch plan against hand-worked cases.

Integer data, so the comparison is exact: keys bit for bit, and the
(key, payload...) rows after a canonical lexsort, since the TPU sort is
unstable on ties. The port's sort is stable: its plain version is checked
bit for bit on every plane against a stable numpy argsort."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops.sort_pallas import LEAF
from dpu_olap_tpu.ops.sort_pallas import sort_bitonic as jax_sort_bitonic
from dpu_olap_tpu_torch.ops import sort_cuda
from dpu_olap_tpu_torch.ops.hashtable import EMPTY


def _canon(cols):
    rows = np.stack([np.asarray(c) for c in cols])
    return rows[:, np.lexsort(rows[::-1])]


def _keys(rng, n):
    """Keys over the whole u32 range below EMPTY, with many duplicates."""
    k = rng.integers(0, int(EMPTY), n, dtype=np.uint32)
    dup = rng.choice(n, n // 4, replace=False)
    k[dup] = rng.integers(2**31, 2**31 + 50, n // 4, dtype=np.uint32)
    return k


@pytest.mark.parametrize("n", [1 << 13, (1 << 13) + 37])
@pytest.mark.parametrize("n_pay", [1, 3])
def test_sort_matches_jax_sort_bitonic(n, n_pay):
    rng = np.random.default_rng(n + n_pay)
    key = _keys(rng, n)
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
    got = sort_cuda.sort_bitonic(tuple(torch.from_numpy(a) for a in (key, *pays)))
    exp = jax_sort_bitonic(tuple(jnp.asarray(a) for a in (key, *pays)), interpret=True)
    got = [t.numpy() for t in got]
    exp = [np.asarray(e) for e in exp]
    assert all(g.dtype == np.uint32 and g.shape == (n,) for g in got)
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(_canon(got), _canon(exp))
    np.testing.assert_array_equal(_canon(got), _canon([key, *pays]))


def test_sort_key_only_and_minimum_length():
    k = torch.from_numpy(np.array([0xFFFFFFFE, 2**31], np.uint32))
    (s,) = sort_cuda.sort_bitonic((k,))
    np.testing.assert_array_equal(s.numpy(), [2**31, 0xFFFFFFFE])
    assert sort_cuda.sortable_bitonic(2) and not sort_cuda.sortable_bitonic(1)


def test_sort_cpu_path_launches_no_kernel():
    before = sort_cuda.LAUNCHES
    k = torch.from_numpy(np.arange(16, dtype=np.uint32)[::-1].copy())
    sort_cuda.sort_bitonic((k, k))
    assert sort_cuda.LAUNCHES == before


def _u32(n):
    return torch.zeros(n, dtype=torch.uint32)


@pytest.mark.parametrize(
    "planes, match",
    [
        (lambda: (), "key plane"),
        (lambda: (_u32(8),) * 10, "at most 8 payload"),
        (lambda: (torch.zeros(8, dtype=torch.int32),), "uint32"),
        (lambda: (_u32(8), _u32(7)), "one length"),
        (lambda: (_u32(1),), "n >= 2"),
        (lambda: (_u32(8).reshape(2, 4),), "1-D"),
        (lambda: (torch.zeros(8, dtype=torch.uint32, device="meta"),), "cuda or cpu"),
    ],
    ids=["empty", "too_many_payloads", "dtype", "ragged", "short", "2d", "meta_device"],
)
def test_sort_rejects_bad_planes(planes, match):
    with pytest.raises(ValueError, match=match):
        sort_cuda.sort_bitonic(planes())


def _planes(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _stable(key, pays):
    order = np.argsort(key, kind="stable")
    return [key[order], *(p[order] for p in pays)]


def test_sort_plain_path_is_stable_on_ties():
    rng = np.random.default_rng(1)
    n = 5000
    key = rng.integers(0, 7, n, dtype=np.uint32)  # every key repeats
    pos = np.arange(n, dtype=np.uint32)
    got = sort_cuda.sort_bitonic(_planes(key, pos))
    for g, e in zip(got, _stable(key, [pos])):
        np.testing.assert_array_equal(g.numpy(), e)
    for k in range(7):  # equal keys keep their input order
        run = got[1].numpy()[got[0].numpy() == k]
        assert np.all(np.diff(run.astype(np.int64)) > 0)


def test_sort_keeps_payloads_of_max_keys():
    rng = np.random.default_rng(2)
    n = 1000
    key = rng.integers(0, 2**32, n, dtype=np.uint32)
    key[rng.choice(n, 300, replace=False)] = EMPTY
    pay = rng.permutation(n).astype(np.uint32)  # distinct payloads
    got = sort_cuda.sort_bitonic(_planes(key, pay))
    exp = _stable(key, [pay])
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), e)
    np.testing.assert_array_equal(np.sort(got[1].numpy()[got[0].numpy() == EMPTY]),
                                  np.sort(pay[key == EMPTY]))


@pytest.mark.parametrize("n_pay", [0, 8])
def test_sort_takes_zero_and_eight_payloads(n_pay):
    rng = np.random.default_rng(3 + n_pay)
    n = 4099
    key = _keys(rng, n)
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
    got = sort_cuda.sort_bitonic(_planes(key, *pays))
    assert len(got) == 1 + n_pay
    for g, e in zip(got, _stable(key, pays)):
        assert g.dtype == torch.uint32 and g.shape == (n,)
        np.testing.assert_array_equal(g.numpy(), e)


@pytest.mark.parametrize("n", [2, 129, 4097])
def test_sort_matches_jax_sort_bitonic_short(n):
    """At lengths under the TPU sort's default two leaves of 4096: its leaf
    is the largest power of two up to n / 2 (at least the 64 its cascade
    needs). n = 2 is under even that, so the JAX sort gets the input padded
    to 128 with 0xFFFFFFFF keys and payloads, as it pads itself, and the
    result is sliced back."""
    rng = np.random.default_rng(n)
    key = _keys(rng, n)
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(2)]
    m = max(n, 128)
    leaf = min(LEAF, max(64, 1 << ((m // 2).bit_length() - 1)))
    padded = [np.concatenate([a, np.full(m - n, EMPTY, np.uint32)]) for a in (key, *pays)]
    exp = jax_sort_bitonic(tuple(jnp.asarray(a) for a in padded), leaf=leaf, interpret=True)
    exp = [np.asarray(e)[:n] for e in exp]
    got = [t.numpy() for t in sort_cuda.sort_bitonic(_planes(key, *pays))]
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(_canon(got), _canon(exp))


@pytest.mark.parametrize(
    "n, n_pay, tiles, alt_planes",
    [
        (2, 1, 1, 2),
        (4096, 1, 1, 2),  # one whole tile
        (4097, 3, 2, 4),  # one tile + 1; every payload carried
        (4097, 8, 2, 9),
        (1 << 21, 0, 512, 1),  # the key alone
        (1 << 21, 1, 512, 2),
        (1 << 28, 1, 65536, 2),
        ((1 << 32) - 1, 8, 1 << 20, 9),
    ],
)
def test_radix_plan_hand_worked(n, n_pay, tiles, alt_planes):
    plan = sort_cuda.radix_plan(n, n_pay)
    assert plan.tiles == tiles
    # one status word per pass, tile and bucket; then 4 x 256 uint32 counts
    # and 4 uint32 tickets, 4112 bytes = 514 words
    assert plan.scratch_words == 4 * 256 * tiles + 514
    assert plan.alt_planes == alt_planes
    # the ping-pong planes follow, in whole int64 words
    assert plan.work_words == plan.scratch_words + (alt_planes * n + 1) // 2


def test_radix_plan_passes_end_in_the_outputs():
    plan = sort_cuda.PASS_PLANES
    assert len(plan) == sort_cuda.PASSES == 4
    assert plan[0][0] == "in" and plan[-1][1] == "out"
    for (_, wrote), (read, _) in zip(plan, plan[1:]):
        assert read == wrote  # each pass reads what the one before it wrote
    assert all(src != dst for src, dst in plan)


def test_radix_plan_scratch_at_one_sf64_round():
    """256Mi lanes, one payload: two 1 GiB ping-pong planes and 512 MiB of
    look-back words (the module docstring's figures)."""
    n = 256 << 20
    plan = sort_cuda.radix_plan(n, 1)
    assert plan.alt_planes * 4 * n == 2 << 30
    assert plan.scratch_words * 8 == (512 << 20) + 4112
    assert plan.work_words * 8 == (2 << 30) + (512 << 20) + 4112
