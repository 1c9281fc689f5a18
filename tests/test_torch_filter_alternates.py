"""Parity of the port's filter alternates (dpu_olap_tpu_torch.ops.
filter_alt_cuda v2, v3 and v4; CPU paths) with the JAX package's Pallas
kernels v2, v3 and v4 run in interpret mode, and with numpy at lengths the
Pallas kernels do not take. Integer data: exact comparison.

The Pallas kernels take whole blocks only and leave the tails past the
count undefined; the port takes any length and writes ``fill`` (values) and
``n`` (indices) there. So ``[:count]`` and ``count`` are compared, except
for the ``_padded`` wrappers, whose tails are ``fill`` in both packages:
there the whole arrays are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_olap_tpu.ops.filter_pallas2 import filter_compact_pallas2, filter_with_indices_pallas2
from dpu_olap_tpu.ops.filter_pallas3 import (
    filter_compact_pallas3,
    filter_pallas3_padded,
    filter_with_indices_pallas3,
)
from dpu_olap_tpu.ops.filter_pallas4 import (
    filter_compact_pallas4,
    filter_pallas4_padded,
    filter_with_indices_pallas4,
)
from dpu_olap_tpu_torch.ops import filter_alt_cuda as alt
from dpu_olap_tpu_torch.ops import filter_cuda

THR = 1 << 30
THRESHOLDS = [THR, 0, 1 << 31, 0xFFFFFFFF]
PASS = np.uint32(1)
FAIL = np.uint32(1 << 31)

# version: (JAX compact, JAX with indices, two of the JAX kernel's default
# blocks)
VERSIONS = {
    "v2": (filter_compact_pallas2, filter_with_indices_pallas2, 2 * 256 * 128),
    "v3": (filter_compact_pallas3, filter_with_indices_pallas3, 2 * 256 * 128),
    "v4": (filter_compact_pallas4, filter_with_indices_pallas4, 2 * 4 * 128 * 128),
}
PATTERNS = ["all", "none", "alternate", "first_half", "last_half", "single", "sparse", "dense",
            "block_edges", "row_edges", "spill_heavy"]


def _pattern(name, n, rng):
    """tests/test_filter_pallas4.py's adversarial patterns at length n."""
    i = np.arange(n)
    tile, blk = 128 * 128, n // 2
    if name == "all":
        v = np.full(n, PASS)
    elif name == "none":
        v = np.full(n, FAIL)
    elif name == "alternate":
        v = np.where(i % 2 == 0, PASS, FAIL)
    elif name == "first_half":
        v = np.where(i < n // 2, PASS, FAIL)
    elif name == "last_half":
        v = np.where(i >= n // 2, PASS, FAIL)
    elif name == "single":
        v = np.where(i == n - 5, PASS, FAIL)
    elif name == "sparse":
        v = np.where(rng.random(n) < 0.01, PASS, FAIL)
    elif name == "dense":
        v = np.where(rng.random(n) < 0.99, PASS, FAIL)
    elif name == "block_edges":
        v = np.full(n, FAIL)
        v[[0, tile - 1, tile, tile + 1, blk - 1, blk, 2 * blk - 1]] = PASS
    elif name == "row_edges":
        v = np.full(n, FAIL)
        v[i % 128 == 0] = PASS
        v[i % 128 == 127] = PASS
    else:
        assert name == "spill_heavy"
        v = np.full(n, PASS)
        v[rng.integers(0, n, 37)] = FAIL
    return (v + (i % 128).astype(np.uint32)).astype(np.uint32)


@pytest.mark.parametrize("threshold", THRESHOLDS, ids=["2^30", "0", "2^31", "0xFFFFFFFF"])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("version", list(VERSIONS))
def test_alternate_matches_jax_pallas(version, pattern, threshold):
    jcompact, jindices, n = VERSIONS[version]
    v = _pattern(pattern, n, np.random.default_rng(42))
    out, cnt = alt.filter_compact(torch.from_numpy(v), version, threshold)
    jout, jcnt = jcompact(jnp.asarray(v), threshold=threshold, interpret=True)
    c = int(jcnt)
    assert cnt.dtype == torch.uint32 and cnt.dim() == 0 and int(cnt) == c == (v < threshold).sum()
    np.testing.assert_array_equal(out.numpy()[:c], np.asarray(jout)[:c])
    vals, idxs, cnt = alt.filter_with_indices(torch.from_numpy(v), version, threshold)
    jvals, jidxs, jcnt = jindices(jnp.asarray(v), threshold=threshold, interpret=True)
    assert int(cnt) == int(jcnt) == c
    np.testing.assert_array_equal(vals.numpy()[:c], np.asarray(jvals)[:c])
    np.testing.assert_array_equal(idxs.numpy()[:c], np.asarray(jidxs)[:c])
    assert np.all(vals.numpy()[c:] == 0) and np.all(idxs.numpy()[c:] == n)


PADDED = {"v3": filter_pallas3_padded, "v4": filter_pallas4_padded}


@pytest.mark.parametrize("n", [100_000, 2 * 4 * 128 * 128 + 17])
@pytest.mark.parametrize("fill", [0, 7])
@pytest.mark.parametrize("version", list(PADDED))
def test_padded_matches_jax_pallas(version, n, fill):
    jpadded = PADDED[version]
    v = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint32)
    out, cnt = alt.filter_padded(torch.from_numpy(v), version, fill)
    jout, jcnt = jpadded(jnp.asarray(v), fill=fill, interpret=True)
    assert int(cnt) == int(jcnt) == (v < THR).sum()
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("n", [1, 100_000, 3 * 16384 + 17])
@pytest.mark.parametrize("threshold", THRESHOLDS, ids=["2^30", "0", "2^31", "0xFFFFFFFF"])
@pytest.mark.parametrize("version", list(VERSIONS))
def test_alternate_any_length_against_numpy(version, threshold, n):
    v = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint32)
    v[:4] = [0, THR - 1, THR, 0xFFFFFFFF][:n]
    keep = v < threshold
    c = int(keep.sum())
    out, cnt = alt.filter_compact(torch.from_numpy(v), version, threshold, fill=7)
    assert int(cnt) == c
    np.testing.assert_array_equal(out.numpy(), np.concatenate([v[keep], np.full(n - c, 7, np.uint32)]))
    vals, idxs, cnt = alt.filter_with_indices(torch.from_numpy(v), version, threshold)
    assert int(cnt) == c
    np.testing.assert_array_equal(vals.numpy(), np.concatenate([v[keep], np.zeros(n - c, np.uint32)]))
    np.testing.assert_array_equal(idxs.numpy(), np.concatenate([np.flatnonzero(keep), np.full(n - c, n)]))


@pytest.mark.parametrize("version", list(VERSIONS))
def test_alternate_empty_input(version):
    out, cnt = alt.filter_compact(torch.zeros(0, dtype=torch.uint32), version)
    assert out.shape == (0,) and int(cnt) == 0


@pytest.mark.parametrize("version", list(VERSIONS))
def test_cpu_path_launches_no_kernel(version):
    before = dict(alt.LAUNCHES)
    v = torch.from_numpy(np.arange(10, dtype=np.uint32))
    alt.filter_compact(v, version)
    alt.filter_with_indices(v, version, 5)
    assert alt.LAUNCHES == before


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize(
    "make, match",
    [
        (lambda v: alt.filter_compact(torch.zeros(4, dtype=torch.uint32, device="meta"), v),
         "cuda or cpu"),
        (lambda v: alt.filter_with_indices(torch.zeros(4, dtype=torch.uint32, device="meta"), v),
         "cuda or cpu"),
        (lambda v: alt.filter_compact(torch.zeros(4, dtype=torch.int32), v), "uint32"),
        (lambda v: alt.filter_with_indices(torch.zeros(4, dtype=torch.int32), v), "uint32"),
        (lambda v: alt.filter_compact(torch.zeros(4, dtype=torch.uint32), v, 1 << 32), "threshold"),
        (lambda v: alt.filter_compact(torch.zeros(4, dtype=torch.uint32), v, -1), "threshold"),
    ],
    ids=["meta_compact", "meta_indices", "int32_compact", "int32_indices", "thr_2^32", "thr_neg"],
)
def test_alternate_rejects_bad_inputs(version, make, match):
    with pytest.raises(ValueError, match=match):
        make(version)


@pytest.mark.parametrize("call", [alt.filter_compact, alt.filter_with_indices, alt.filter_padded,
                                  alt.filter_compact_ref, alt.filter_with_indices_ref])
def test_unknown_version_raises(call):
    with pytest.raises(ValueError, match="filter version"):
        call(torch.zeros(4, dtype=torch.uint32), "v1")


def test_v2_plain_version_is_the_gather_form():
    """The v2 plain version finds each slot's source by searchsorted over
    the mask prefix; it agrees with the scatter form on every lane."""
    v = np.random.default_rng(9).integers(0, 2**32, 5000, dtype=np.uint32)
    t = torch.from_numpy(v)
    for thr in THRESHOLDS:
        got = alt.filter_with_indices_ref(t, "v2", thr)
        ref = alt.filter_with_indices_ref(t, "v3", thr)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())


# n: tiles of 4096 values (at least one scratch word, so a call of none
# still gets a pointer)
SCRATCH_CASES = [(0, 0), (1, 1), (4096, 1), (4097, 2), (8 << 20, 2048), (64 << 20, 16384),
                 ((1 << 32) - 1, 1 << 20)]


@pytest.mark.parametrize("n, tiles", SCRATCH_CASES)
@pytest.mark.parametrize("version", list(VERSIONS))
def test_scratch_words_hand_worked(version, n, tiles):
    words = alt.scratch_words(version, n)
    assert words == tiles + 1  # a status word a tile, then the ticket: v1's filter_plan
    assert words == filter_cuda.filter_plan(n).work_words


@pytest.mark.parametrize("version", list(VERSIONS))
def test_scratch_is_int64_status_words(version):
    """Every alternate's work memory is filter_plan's 64-bit words: a flag and
    a count in each status word, as csrc/lookback.cuh publishes them."""
    entry, dtype, extra = alt._ENTRIES[version]
    assert entry == f"dpu_filter{version[1]}_u32"
    assert dtype == torch.int64 and extra == 1
