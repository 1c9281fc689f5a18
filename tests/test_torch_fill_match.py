"""The co-sort joins' fill and match in one step
(dpu_olap_tpu_torch.ops.fill_match_cuda ``fill_match_k2``, merge.fill_match) on
the CPU:

  * the plain version against the rules in numpy and against the generic
    join's fill and match (propagate_fill, then the match) on the decoded
    keys, bit for bit, at lengths around the kernel's tile, with 0 to 3
    payloads on each side, EMPTY pk lanes (0xFFFFFFFE), pad and masked fk
    lanes (0xFFFFFFFF), fk lanes before any pk, unmatched fks between pks,
    a pk run that crosses tiles, and unsorted keys;
  * the kernel's source (csrc/scan.cu) compiled with the host C++ compiler
    against tests/block_ops_emu.h, as tests/test_torch_probes_emulated.py
    compiles csrc/probes.cu (one std::thread a CUDA thread, one block at a
    time in ticket order, so the look-back finds every earlier tile done),
    against the plain version on the same cases and on views that are not
    16-byte aligned; the forward fill's kernel of the same file beside it;
  * the joins that run the step (join_shard_fused with keys31, with filter
    masks, and join_shard_sorted_build) against the JAX package, the
    counter ``join.fill_match`` once a call there and never on the generic
    join, and the wrapper's argument checks;
  * the compacting form (``fill_match_compact_k2``, merge.fill_match_compact):
    its plain version against ``fill_match_k2_ref`` followed by the boolean
    selection of the matched rows, the kernel's source against the plain
    version on the same kinds (no match, all matched, dead stretches over
    many tiles among them), at the tile's edges, on misaligned views and
    below a capacity that cuts the rows, and the wrapper's checks.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops import join as jjoin
from dpu_olap_tpu.ops.merge_xla import join_shard_sorted_build as jax_sorted_build
from dpu_olap_tpu_torch import metrics
from dpu_olap_tpu_torch.ops import fill_match_compact_cuda, fill_match_cuda, join, merge, scan_cuda
from fill_match_cases import KINDS, k2_case

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "dpu_olap_tpu_torch" / "csrc" / "scan.cu"
HEADER = Path(__file__).resolve().parent / "block_ops_emu.h"
EMPTY = 0xFFFFFFFF
TILE = scan_cuda.TILE
LENGTHS = [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5]
SIDES = [(0, 0), (1, 1), (0, 1), (1, 0), (2, 1), (1, 3), (3, 2), (3, 3)]  # (m_l, m_r)


def _case(kind: str, n: int, m: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    k2 = k2_case(kind, n, rng)
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(m)]
    return (torch.from_numpy(k2), *(torch.from_numpy(p) for p in pays))


def _rules(planes, m_l: int, m_r: int) -> tuple:
    """The step's outputs by its rules, in numpy: a lane is live where k2 is
    even and below 0xFFFFFFFE; its carry the nearest live lane at or before
    it; matched where a carry holds the lane's key, k2 is odd and the key is
    not EMPTY."""
    k2 = planes[0].numpy().astype(np.int64)
    pays = [p.numpy() for p in planes[1:]]
    live = ((k2 & 1) == 0) & (k2 < 0xFFFFFFFE)
    src = np.maximum.accumulate(np.where(live, np.arange(len(k2)), -1))
    own = np.where(k2 >= 0xFFFFFFFE, EMPTY, k2 >> 1)
    carry = np.where(src >= 0, own[np.maximum(src, 0)], EMPTY)
    matched = (src >= 0) & (carry == own) & ((k2 & 1) == 1) & (own != EMPTY)
    pick = np.maximum(src, 0)
    return (np.where(matched, own, 0).astype(np.uint32),
            [np.where(matched, pays[q], 0).astype(np.uint32) for q in range(m_l)],
            [np.where(matched, pays[q][pick], 0).astype(np.uint32) for q in range(m_r)],
            matched)


def _flat(res) -> list:
    key, out_l, out_r, matched = res
    return [key, *out_l, *out_r, matched]


def _assert_same(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("m_l, m_r", SIDES)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_follows_the_rules_and_the_generic_tail(kind, n, m_l, m_r):
    planes = _case(kind, n, max(m_l, m_r), seed=n + 10 * m_l + m_r)
    got = fill_match_cuda.fill_match_k2(planes, m_l, m_r)  # CPU tensors: the plain version
    _assert_same(got, fill_match_cuda.fill_match_k2_ref(planes, m_l, m_r))
    _assert_same(got, _rules(planes, m_l, m_r))
    sk, is_pk = fill_match_cuda._decode_k2(planes[0])
    _assert_same(got, merge._fill_match(sk, is_pk, planes[1:], m_l, m_r))
    if kind == "run" and n > TILE:  # the pk's carry reaches past the first tile
        assert bool(got[3][TILE:].all())


def test_cpu_path_launches_nothing():
    planes = _case("sorted", TILE + 1, 1, seed=4)
    before = (fill_match_cuda.LAUNCHES, scan_cuda.LAUNCHES)
    fill_match_cuda.fill_match_k2(planes, 1, 1)
    assert (fill_match_cuda.LAUNCHES, scan_cuda.LAUNCHES) == before


def test_extra_payload_planes_are_not_read():
    planes = _case("sorted", 2 * TILE, 3, seed=1)
    _assert_same(fill_match_cuda.fill_match_k2(planes, 1, 1), fill_match_cuda.fill_match_k2(planes[:2], 1, 1))


@pytest.mark.parametrize("planes, m_l, m_r, match", [
    (1, 1, 0, "needs k2 and max"),  # a payload plane missing
    (3, -1, 1, "needs k2 and max"),
    (10, 9, 0, "at most 9 planes"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(planes, m_l, m_r, match):
    with pytest.raises(ValueError, match=match):
        fill_match_cuda.fill_match_k2(_case("sorted", 64, planes - 1, seed=2), m_l, m_r)


def test_wrapper_refuses_other_dtypes():
    k2, pay = _case("sorted", 64, 1, seed=3)
    with pytest.raises(ValueError, match="uint32"):
        fill_match_cuda.fill_match_k2((k2.view(torch.int32), pay), 1, 1)


# ---- the kernel's source on the CPU --------------------------------------------

def _host_source(src: str) -> str:
    """scan.cu as host C++: the CUDA runtime and the launches replaced by the
    stand-in's."""
    src = src.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    src, n = re.subn(r"(\w+(?:<[^<>()]*>)?)<<<(.*?)>>>\(", r"emu::Launch(\2).run(\1)(", src,
                     flags=re.S)
    assert n == 2  # the fill and the fill and match
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++ or clang++) with C++20's <barrier>")
    d = tmp_path_factory.mktemp("scan_emu")
    cpp = d / "scan_emu.cpp"
    cpp.write_text(_host_source(SOURCE.read_text()))
    so = d / "libscan_emu.so"
    res = subprocess.run([cxx, "-std=c++20", "-O1", "-Wall", "-Wno-unknown-pragmas",
                          "-Wno-sign-compare", "-shared", "-fPIC", "-pthread", "-o", str(so),
                          str(cpp)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    ptr, ptrs, ll = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong
    lib.dpu_fill_match_u32.argtypes = [ptrs, ctypes.c_int, ctypes.c_int, ll, ptr, ptrs, ptrs,
                                       ptr, ptr, ptr]
    lib.dpu_fill_u32.argtypes = [ptrs, ptrs, ctypes.c_int, ll, ctypes.c_uint, ptr, ptr, ptr, ptr]
    lib.dpu_fill_match_compact_u32.argtypes = [ptrs, ctypes.c_int, ctypes.c_int, ll, ll, ptr,
                                               ptrs, ptrs, ptr, ptr]
    lib.dpu_fill_match_u32.restype = lib.dpu_fill_u32.restype = ctypes.c_int
    lib.dpu_fill_match_compact_u32.restype = ctypes.c_int
    return lib


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """t's values in a view `offset` elements into a larger buffer."""
    buf = torch.zeros(t.shape[0] + offset, dtype=t.dtype)
    buf[offset:] = t
    return buf[offset:]


def _emulated_fill_match(lib, planes, m_l, m_r, offset=0):
    n = planes[0].shape[0]
    planes = [_view(p, offset) for p in planes[:1 + max(m_l, m_r)]]
    key = _view(torch.full((n,), 0xAB, dtype=torch.uint32), offset)
    out_l = [torch.full((n,), 0xCD, dtype=torch.uint32) for _ in range(m_l)]
    out_r = [_view(torch.full((n,), 0xEF, dtype=torch.uint32), offset) for _ in range(m_r)]
    matched = _view(torch.ones(n, dtype=torch.bool), offset)
    work = torch.full((scan_cuda.fill_plan(n).work_words,), -1, dtype=torch.int64)
    rc = lib.dpu_fill_match_u32(_ptrs(planes), m_l, m_r, n, key.data_ptr(), _ptrs(out_l),
                                _ptrs(out_r), matched.data_ptr(), work.data_ptr(), None)
    assert rc == 0
    return key, tuple(out_l), tuple(out_r), matched


@pytest.mark.parametrize("m_l, m_r", [(1, 1), (0, 0), (2, 1), (1, 3)])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE + 1, 3 * TILE + 5])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_source_equals_plain(lib, kind, n, m_l, m_r):
    planes = _case(kind, n, max(m_l, m_r), seed=7 * n + m_l + m_r)
    _assert_same(_emulated_fill_match(lib, planes, m_l, m_r),
                 fill_match_cuda.fill_match_k2_ref(planes, m_l, m_r))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_source_on_misaligned_views(lib, offset):
    planes = _case("sorted", 2 * TILE + 7, 2, seed=offset)
    _assert_same(_emulated_fill_match(lib, planes, 2, 1, offset),
                 fill_match_cuda.fill_match_k2_ref(planes, 2, 1))


def test_kernel_source_refuses_nine_payloads(lib):
    k2 = torch.zeros(8, dtype=torch.uint32)
    assert lib.dpu_fill_match_u32(_ptrs([k2] * 10), 9, 0, 8, k2.data_ptr(), _ptrs([k2] * 9),
                                  _ptrs([]), k2.data_ptr(), k2.data_ptr(), None) != 0


@pytest.mark.parametrize("n_pay", [1, 2, 8])
@pytest.mark.parametrize("n", [TILE - 1, 3 * TILE + 5])
def test_fill_kernel_source_equals_plain(lib, n, n_pay):
    """The forward fill's kernel, which shares the sweep's tile prefix and
    look-back with the fill and match."""
    rng = np.random.default_rng(n + n_pay)
    live = rng.random(n) < 0.01
    key = np.where(live, rng.integers(0, 2**31, n), EMPTY).astype(np.uint32)
    planes = [torch.from_numpy(key), *(torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32))
                                       for _ in range(n_pay))]
    outs = [torch.empty_like(p) for p in planes]
    work = torch.full((scan_cuda.fill_plan(n).work_words,), -1, dtype=torch.int64)
    assert lib.dpu_fill_u32(_ptrs(planes), _ptrs(outs), len(planes), n, EMPTY, None, None,
                            work.data_ptr(), None) == 0
    for got, want in zip(outs, scan_cuda.propagate_fill_ref(planes)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---- the compacting form ------------------------------------------------------

COMPACT_LENGTHS = [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5, 9 * TILE + 3]


def _selected(planes, m_l, m_r):
    """fill_match_k2_ref, then the matched rows by boolean selection."""
    key, out_l, out_r, matched = fill_match_cuda.fill_match_k2_ref(planes, m_l, m_r)

    def rows(p):
        return p.view(torch.int32)[matched].view(torch.uint32)

    return rows(key), tuple(map(rows, out_l)), tuple(map(rows, out_r)), int(matched.sum())


def _assert_compacted(got, want, cap):
    """got (key, out_l, out_r, count) holds want's rows up to cap and want's count."""
    key, out_l, out_r, count = got
    wkey, wl, wr, wcount = want
    assert int(count) == wcount
    kept = min(wcount, cap)
    for g, w in zip([key, *out_l, *out_r], [wkey, *wl, *wr]):
        assert g.dtype == torch.uint32 and g.shape == (cap,)
        assert torch.equal(g[:kept].view(torch.int32), w[:kept].view(torch.int32))


@pytest.mark.parametrize("m_l, m_r", SIDES)
@pytest.mark.parametrize("n", COMPACT_LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_compact_plain_version_is_the_step_then_the_selection(kind, n, m_l, m_r):
    planes = _case(kind, n, max(m_l, m_r), seed=3 * n + 10 * m_l + m_r)
    # CPU: the plain version
    got = fill_match_compact_cuda.fill_match_compact_k2(planes, m_l, m_r, n)
    want = _selected(planes, m_l, m_r)
    _assert_compacted(got, want, n)
    if kind == "none":
        assert want[3] == 0
    if kind == "all":  # every fk lane matched
        assert want[3] == int((planes[0] & 1).sum())


def test_compact_plain_version_below_the_count():
    planes = _case("sorted", 2 * TILE, 1, seed=8)
    want = _selected(planes, 1, 1)
    cap = want[3] // 2
    got = fill_match_compact_cuda.fill_match_compact_k2(planes, 1, 1, cap)
    _assert_compacted(got, want, cap)


def _emulated_compact(lib, planes, m_l, m_r, cap, offsets=(0, 0, 0)):
    """The kernel's compacting form under the stand-in, the input planes at
    offsets[0] elements into their buffers, key and out_l at offsets[1],
    out_r at offsets[2]; every output lane first 0xAB."""
    n = planes[0].shape[0]
    planes = [_view(p, offsets[0]) for p in planes[:1 + max(m_l, m_r)]]

    def out(offset):
        return _view(torch.full((cap,), 0xAB, dtype=torch.uint32), offset)

    key = out(offsets[1])
    out_l = [out(offsets[1]) for _ in range(m_l)]
    out_r = [out(offsets[2]) for _ in range(m_r)]
    work = torch.full((fill_match_compact_cuda.compact_words(n),), -1, dtype=torch.int64)
    rc = lib.dpu_fill_match_compact_u32(_ptrs(planes), m_l, m_r, n, cap, key.data_ptr(),
                                        _ptrs(out_l), _ptrs(out_r), work.data_ptr(), None)
    assert rc == 0
    return key, tuple(out_l), tuple(out_r), work[-1]


@pytest.mark.parametrize("m_l, m_r", [(1, 1), (0, 0), (2, 1), (1, 3), (3, 0)])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5])
@pytest.mark.parametrize("kind", KINDS)
def test_compact_kernel_source_equals_plain(lib, kind, n, m_l, m_r):
    planes = _case(kind, n, max(m_l, m_r), seed=5 * n + m_l + m_r)
    got = _emulated_compact(lib, planes, m_l, m_r, n)
    _assert_compacted(got, _selected(planes, m_l, m_r), n)
    # the rows past the count are not written
    count = int(got[3])
    assert all(bool((p[count:] == 0xAB).all()) for p in (got[0], *got[1], *got[2]))


@pytest.mark.parametrize("kind", ["dead", "run", "sorted"])
def test_compact_kernel_source_over_many_tiles(lib, kind):
    """Stretches of several tiles with no match, and a carry across them."""
    planes = _case(kind, 17 * TILE + 9, 1, seed=17)
    _assert_compacted(_emulated_compact(lib, planes, 1, 1, 17 * TILE + 9),
                      _selected(planes, 1, 1), 17 * TILE + 9)


@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 1, 2), (3, 2, 1), (2, 3, 3)])
def test_compact_kernel_source_on_misaligned_views(lib, offsets):
    planes = _case("sorted", 2 * TILE + 7, 2, seed=sum(offsets))
    n = planes[0].shape[0]
    _assert_compacted(_emulated_compact(lib, planes, 2, 1, n, offsets),
                      _selected(planes, 2, 1), n)


@pytest.mark.parametrize("cut", [0, 1, 2, 5, TILE // 3])
def test_compact_kernel_source_below_the_count(lib, cut):
    """A capacity below the count: the rows under it written, none past it,
    the count whole."""
    planes = _case("sorted", 3 * TILE + 5, 1, seed=cut)
    want = _selected(planes, 1, 1)
    cap = max(0, want[3] - cut) if cut else 0
    key, _, (out_r,), count = _emulated_compact(lib, planes, 1, 1, cap)
    _assert_compacted((key, (), (out_r,), count), (want[0], (), (want[2][0],), want[3]), cap)


def test_compact_kernel_source_refuses_what_it_does_not_take(lib):
    k2 = torch.zeros(8, dtype=torch.uint32)
    assert lib.dpu_fill_match_compact_u32(_ptrs([k2] * 10), 9, 0, 8, 8, k2.data_ptr(),
                                          _ptrs([k2] * 9), _ptrs([]), k2.data_ptr(), None) != 0
    assert lib.dpu_fill_match_compact_u32(_ptrs([k2]), 0, 0, 8, -1, k2.data_ptr(), _ptrs([]),
                                          _ptrs([]), k2.data_ptr(), None) != 0


@pytest.mark.parametrize("planes, m_l, m_r, cap, match", [
    (1, 1, 0, 4, "needs k2 and max"),
    (3, -1, 1, 4, "needs k2 and max"),
    (10, 9, 0, 4, "at most 9 planes"),
    (2, 1, 1, -1, "capacity >= 0"),
])
def test_compact_wrapper_refuses_what_the_kernel_does_not_take(planes, m_l, m_r, cap, match):
    with pytest.raises(ValueError, match=match):
        fill_match_compact_cuda.fill_match_compact_k2(_case("sorted", 64, planes - 1, seed=2),
                                                      m_l, m_r, cap)


def test_compact_wrapper_refuses_other_dtypes():
    k2, pay = _case("sorted", 64, 1, seed=3)
    with pytest.raises(ValueError, match="uint32"):
        fill_match_compact_cuda.fill_match_compact_k2((k2, pay.view(torch.int32)), 1, 1, 64)


def test_compact_cpu_path_launches_nothing_and_counts_its_step():
    planes = _case("sorted", TILE + 1, 1, seed=4)
    launches = (fill_match_cuda.LAUNCHES, fill_match_compact_cuda.LAUNCHES, scan_cuda.LAUNCHES)
    before = metrics.counts()
    merge.fill_match_compact(planes, 1, 1, TILE + 1)
    assert (fill_match_cuda.LAUNCHES, fill_match_compact_cuda.LAUNCHES,
            scan_cuda.LAUNCHES) == launches
    counted = {k: v - before.get(k, 0) for k, v in metrics.counts().items()
               if k.startswith("join.") and v != before.get(k, 0)}
    assert counted == {"join.fill_match_compact": 1}


# ---- the joins that run the step ------------------------------------------------

def _flat_tuple(res):
    key, out_l, out_r, matched = res
    conv = (lambda x: x.numpy()) if isinstance(key, torch.Tensor) else np.asarray
    return conv(key), [conv(c) for c in out_l], [conv(c) for c in out_r], conv(matched)


def _canon(res) -> np.ndarray:
    """The matched rows (key, left and right payloads) in a canonical order:
    equal keys may order their payloads differently after two sorts."""
    key, out_l, out_r, matched = _flat_tuple(res)
    rows = np.stack([key[matched], *(c[matched] for c in (*out_l, *out_r))])
    return rows[:, np.lexsort(rows[::-1])]


def _join_case(m_l: int, m_r: int, seed: int):
    """A build side of unique keys below 2^31 - 1, half of it masked out;
    probe rows that mostly find a pk, some with a masked pk or none, a
    quarter masked out; m_l and m_r payloads."""
    rng = np.random.default_rng(seed)
    n_r, n_l = 1000, 3000
    pk = rng.choice(2**31 - 1, size=n_r, replace=False).astype(np.uint32)
    fk = np.where(rng.random(n_l) < 0.9, pk[rng.integers(0, n_r, n_l)],
                  rng.integers(0, 2**31 - 1, n_l)).astype(np.uint32)
    r_valid, l_valid = rng.random(n_r) < 0.5, rng.random(n_l) < 0.75
    ys = [rng.integers(0, 2**32, n_l, dtype=np.uint32) for _ in range(m_l)]
    xs = [rng.integers(0, 2**32, n_r, dtype=np.uint32) for _ in range(m_r)]
    return fk, ys, pk, xs, l_valid, r_valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m_l, m_r", [(0, 0), (0, 2), (3, 1), (2, 2)])
def test_fused_keys31_with_masks_matches_jax(m_l, m_r):
    fk, ys, pk, xs, l_valid, r_valid = _join_case(m_l, m_r, seed=10 * m_l + m_r)
    before = metrics.counts()
    got = join.join_shard_fused(_t(fk), tuple(map(_t, ys)), _t(pk), tuple(map(_t, xs)),
                                left_valid=_t(l_valid), right_valid=_t(r_valid), keys31=True)
    assert metrics.counts()["join.fill_match"] - before.get("join.fill_match", 0) == 1
    ref = jjoin.join_shard_fused(jnp.asarray(fk), tuple(map(jnp.asarray, ys)), jnp.asarray(pk),
                                 tuple(map(jnp.asarray, xs)), left_valid=jnp.asarray(l_valid),
                                 right_valid=jnp.asarray(r_valid), keys31=True)
    g, r = _flat_tuple(got), _flat_tuple(ref)
    np.testing.assert_array_equal(g[0], r[0])
    np.testing.assert_array_equal(g[3], r[3])
    np.testing.assert_array_equal(_canon(got), _canon(ref))
    want = int(np.isin(fk[l_valid], pk[r_valid]).sum())
    assert int(got[3].sum()) == want > 0


@pytest.mark.parametrize("m_l, m_r", [(1, 1), (2, 0), (0, 3)])
def test_sorted_build_matches_jax(m_l, m_r):
    fk, ys, pk, xs, _, _ = _join_case(m_l, m_r, seed=5 + m_l)
    pk = np.sort(pk)
    got = merge.join_shard_sorted_build(_t(fk), tuple(map(_t, ys)), _t(pk), tuple(map(_t, xs)))
    ref = jax_sorted_build(jnp.asarray(fk), tuple(map(jnp.asarray, ys)), jnp.asarray(pk),
                           tuple(map(jnp.asarray, xs)))
    g, r = _flat_tuple(got), _flat_tuple(ref)
    np.testing.assert_array_equal(g[0], r[0])
    np.testing.assert_array_equal(g[3], r[3])
    np.testing.assert_array_equal(_canon(got), _canon(ref))


def test_generic_join_counts_no_fill_match():
    fk, (y,), pk, (x,), _, _ = _join_case(1, 1, seed=4)
    fk[0] = pk[0] = 0xFFFFFFF0  # a key above 2^31 - 1: no packed key
    before = metrics.counts()
    got = join.join_shard_fused(_t(fk), (_t(y),), _t(pk), (_t(x),), keys31=False)
    assert metrics.counts().get("join.fill_match", 0) == before.get("join.fill_match", 0)
    assert bool(got[3].any())
