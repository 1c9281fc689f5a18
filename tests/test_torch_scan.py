"""Parity of the port's forward fill (dpu_olap_tpu_torch.ops.scan_cuda) with
the JAX package's Pallas kernels propagate_fill and propagate_last, run in
interpret mode on the CPU. uint32 data: exact comparison. The JAX kernels
leave lanes with no live position before them unspecified in their
payloads (scan_pallas.py:124-125), so JAX is compared on the lanes that
have one; the port's own value there (the sentinel, or 0 for
propagate_last) is checked against numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops.scan_pallas import propagate_fill as jax_propagate_fill
from dpu_olap_tpu.ops.scan_pallas import propagate_last as jax_propagate_last
from dpu_olap_tpu_torch.ops import scan_cuda
from dpu_olap_tpu_torch.ops.scan_cuda import propagate_fill, propagate_last

EMPTY = 0xFFFFFFFF
R = 8  # JAX block rows: blocks of 1024 elements keep interpret mode fast
BLK = R * 128


def _last_idx(alive):
    return np.maximum.accumulate(np.where(alive, np.arange(len(alive)), -1))


def _fill_case(rng, n, density):
    alive = rng.random(n) < density
    key = np.where(alive, rng.integers(0, 2**31, n, dtype=np.uint32), np.uint32(EMPTY))
    pay = rng.integers(0, 2**32, n, dtype=np.uint32)
    return alive, key, pay


@pytest.mark.parametrize("density", [0.0, 0.002, 0.5, 1.0])
def test_propagate_fill_matches_jax(density):
    rng = np.random.default_rng(3)
    n = 6 * BLK
    alive, key, pay = _fill_case(rng, n, density)
    fk, fp = (t.numpy() for t in propagate_fill((torch.from_numpy(key), torch.from_numpy(pay))))
    jk, jp = (np.asarray(a) for a in jax_propagate_fill(
        (jnp.asarray(key), jnp.asarray(pay)), block_rows=R, interpret=True))
    src = _last_idx(alive)
    has = src >= 0
    np.testing.assert_array_equal(fk, jk)  # the key plane is defined on every lane
    np.testing.assert_array_equal(fp[has], jp[has])
    np.testing.assert_array_equal(fk[has], key[src[has]])
    np.testing.assert_array_equal(fp[has], pay[src[has]])
    assert np.all(fk[~has] == EMPTY) and np.all(fp[~has] == EMPTY)


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_propagate_last_matches_jax(density):
    rng = np.random.default_rng(5)
    n = 4 * BLK
    alive = rng.random(n) < density
    v1 = rng.integers(0, 2**32, n, dtype=np.uint32)
    v2 = rng.integers(-(2**31), 2**31, n, dtype=np.int32)
    has, (o1, o2) = propagate_last(
        torch.from_numpy(alive), (torch.from_numpy(v1), torch.from_numpy(v2))
    )
    jhas, (j1, j2) = jax_propagate_last(
        jnp.asarray(alive), (jnp.asarray(v1), jnp.asarray(v2)), block_rows=R, interpret=True
    )
    has, jhas = has.numpy(), np.asarray(jhas)
    assert has.dtype == np.bool_ and o1.dtype == torch.uint32 and o2.dtype == torch.int32
    np.testing.assert_array_equal(has, jhas)
    np.testing.assert_array_equal(o1.numpy()[has], np.asarray(j1)[has])
    np.testing.assert_array_equal(o2.numpy()[has], np.asarray(j2)[has])
    src = _last_idx(alive)
    np.testing.assert_array_equal(has, src >= 0)
    np.testing.assert_array_equal(o2.numpy()[has], v2[src[has]])
    assert not o1.numpy()[~has].any() and not o2.numpy()[~has].any()  # 0-filled


@pytest.mark.parametrize("fn", ["fill", "last"])
def test_propagate_block_boundary_carries_across_blocks(fn):
    # a single live element just before a block boundary carries through
    # every later block
    rng = np.random.default_rng(9)
    n = 3 * BLK
    alive = np.zeros(n, bool)
    alive[BLK - 2] = True
    v = rng.integers(0, 2**32, n, dtype=np.uint32)
    if fn == "fill":
        key = np.where(alive, np.uint32(77), np.uint32(EMPTY))
        ok, o = (t.numpy() for t in propagate_fill((torch.from_numpy(key), torch.from_numpy(v))))
        jk, jo = (np.asarray(a) for a in jax_propagate_fill(
            (jnp.asarray(key), jnp.asarray(v)), block_rows=R, interpret=True))
        has = ok != EMPTY
        np.testing.assert_array_equal(ok, jk)
    else:
        h, (o,) = propagate_last(torch.from_numpy(alive), (torch.from_numpy(v),))
        jh, (jo,) = jax_propagate_last(jnp.asarray(alive), (jnp.asarray(v),), block_rows=R,
                                       interpret=True)
        has, jo, o = h.numpy(), np.asarray(jo), o.numpy()
        np.testing.assert_array_equal(has, np.asarray(jh))
    assert not has[: BLK - 2].any() and has[BLK - 2:].all()
    assert (o[BLK - 2:] == v[BLK - 2]).all() and (jo[BLK - 2:] == v[BLK - 2]).all()


@pytest.mark.parametrize("fn", ["fill", "last"])
def test_propagate_value_msb_preserved(fn):
    # payloads with the high bit set survive (the TPU kernel's int32 carry)
    n = 2 * BLK
    alive = np.zeros(n, bool)
    alive[7] = True
    v = np.zeros(n, np.uint32)
    v[7] = 0xDEADBEEF
    if fn == "fill":
        key = np.where(alive, np.uint32(0x80000001), np.uint32(EMPTY))
        ok, o = (t.numpy() for t in propagate_fill((torch.from_numpy(key), torch.from_numpy(v))))
        _, jo = jax_propagate_fill((jnp.asarray(key), jnp.asarray(v)), block_rows=R, interpret=True)
        assert ok[-1] == 0x80000001
    else:
        _, (o,) = propagate_last(torch.from_numpy(alive), (torch.from_numpy(v),))
        _, (jo,) = jax_propagate_last(jnp.asarray(alive), (jnp.asarray(v),), block_rows=R,
                                      interpret=True)
        o = o.numpy()
    assert o[-1] == np.asarray(jo)[-1] == 0xDEADBEEF


@pytest.mark.parametrize("n", [0, 1, 4097])
def test_propagate_any_length(n):
    # no block padding: lengths the TPU kernel's wrapper would pad
    rng = np.random.default_rng(n)
    alive, key, pay = _fill_case(rng, n, 0.3)
    fk, fp = (t.numpy() for t in propagate_fill((torch.from_numpy(key), torch.from_numpy(pay)),
                                                 sentinel=EMPTY))
    src = _last_idx(alive)
    has = src >= 0
    np.testing.assert_array_equal(fk[has], key[src[has]])
    np.testing.assert_array_equal(fp[has], pay[src[has]])
    assert np.all(fk[~has] == EMPTY) and np.all(fp[~has] == EMPTY)
    h, (o,) = propagate_last(torch.from_numpy(alive.astype(np.int32)), (torch.from_numpy(pay),))
    np.testing.assert_array_equal(h.numpy(), has)
    np.testing.assert_array_equal(o.numpy(), np.where(has, pay[np.maximum(src, 0)], 0))


def test_propagate_fill_other_sentinel():
    key = np.array([5, 0, 0, 9, 0], np.uint32)
    pay = np.array([1, 2, 3, 4, 5], np.uint32)
    fk, fp = propagate_fill((torch.from_numpy(key), torch.from_numpy(pay)), sentinel=0)
    np.testing.assert_array_equal(fk.numpy(), [5, 5, 5, 9, 9])
    np.testing.assert_array_equal(fp.numpy(), [1, 1, 1, 4, 4])


def test_propagate_rejects_bad_planes():
    u = torch.zeros(8, dtype=torch.uint32)
    with pytest.raises(ValueError, match="at most 9"):
        propagate_fill((u,) * 10)
    with pytest.raises(ValueError, match="uint32"):
        propagate_fill((u, torch.zeros(8, dtype=torch.int64)))
    with pytest.raises(ValueError, match="one length"):
        propagate_fill((u, u[:4]))
    with pytest.raises(ValueError, match="alive"):
        propagate_last(torch.ones(4, dtype=torch.bool), (u,))
    before = scan_cuda.LAUNCHES
    propagate_fill((u,))
    assert scan_cuda.LAUNCHES == before  # the CPU path launches nothing


@pytest.mark.parametrize("n, tiles, work_words", [
    (1, 1, 2),
    (scan_cuda.TILE, 1, 2),
    (scan_cuda.TILE + 1, 2, 3),
    (8 << 20, 2048, 2049),  # chip_smoke's timed fill
    (256 << 20, 65536, 65537),  # one SF=64 shuffle round's co-sort lanes
])
def test_fill_plan_hand_worked(n, tiles, work_words):
    plan = scan_cuda.fill_plan(n)
    assert plan.tiles == tiles
    # one look-back status word per tile, then the ticket
    assert plan.work_words == work_words == tiles + 1


def test_fill_plan_at_one_sf64_round():
    """256Mi lanes: 512 KiB of look-back words and the ticket's word
    (scan_cuda's docstring)."""
    assert scan_cuda.fill_plan(256 << 20).work_words * 8 == (512 << 10) + 8
    assert scan_cuda.TILE == 4096


U8 = torch.zeros(8, dtype=torch.uint32)


@pytest.mark.parametrize("call, match", [
    (lambda: propagate_fill(()), "at least one plane"),
    (lambda: propagate_fill((U8.reshape(2, 4),)), "1-D"),
    (lambda: propagate_fill((U8.view(torch.int32),)), "uint32"),
    (lambda: propagate_fill((torch.zeros(8, dtype=torch.uint32, device="meta"),)), "cuda or cpu"),
    (lambda: propagate_fill((U8, torch.zeros(8, dtype=torch.uint32, device="meta"))), "one device"),
    (lambda: propagate_last(torch.ones(8, dtype=torch.bool), (U8.to(torch.int64),)), "int32"),
    (lambda: propagate_last(torch.ones(8, dtype=torch.bool), ()), "at least one plane"),
    (lambda: propagate_last(torch.ones((2, 4), dtype=torch.bool), (U8,)), "alive"),
    (lambda: propagate_last(torch.ones(8, dtype=torch.bool, device="meta"), (U8,)), "alive"),
], ids=["no_planes", "rank", "fill_int32", "meta", "two_devices", "last_int64", "last_no_planes",
        "alive_rank", "alive_device"])
def test_propagate_argument_checks(call, match):
    with pytest.raises(ValueError, match=match):
        call()
