"""Parity of the port's probe primitives (dpu_olap_tpu_torch.ops.
probes_cuda; CPU paths) with the Pallas probe kernels in interpret mode:
scripts/measure_r3.py's lane gather ``gk`` and the kernels of the lowering
probes measurements/_probe_v4_lowering.py and _proto_lower.py; the sort's
tile stage (ops.sort_cuda.sort_tiles) against the TPU sort's leaf stage;
and the lowering-probe entry point (bench.probe_lowering) on the CPU.
Integer and 0/1 data: exact comparison.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dpu_olap_tpu.ops.sort_pallas import LEAF
from dpu_olap_tpu_torch.bench import probe_lowering
from dpu_olap_tpu_torch.ops import probes_cuda as pc
from dpu_olap_tpu_torch.ops import sort_cuda

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def v4_probes():
    """measurements/_probe_v4_lowering.py: its kernels import cleanly (its
    main, which exports for the TPU, is guarded)."""
    spec = importlib.util.spec_from_file_location(
        "probe_v4_lowering", REPO / "measurements" / "_probe_v4_lowering.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gk(x_ref, i_ref, o_ref):
    """scripts/measure_r3.py:219-220, restated: it is nested inside
    measure_take2 and cannot be imported."""
    o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=1)


def k_dynrow(x_ref, s_ref, o_ref):
    """measurements/_proto_lower.py:15-18, restated: that module exports
    for the TPU when it is imported."""
    i = s_ref[0]
    o_ref[...] = x_ref[pl.ds(i, 1)]


def _call(kernel, out_shape, dtype, *args, in_specs=None):
    kw = {} if in_specs is None else {"in_specs": in_specs}
    f = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(out_shape, dtype), interpret=True,
                       **kw)
    return np.asarray(f(*[jnp.asarray(a) for a in args]))


def _words(rng, shape, dtype=np.uint32):
    return rng.integers(0, 2**32, shape, dtype=np.uint32).view(dtype)


@pytest.mark.parametrize("wi, kernel", [(128, "gk"), (128, "k_gather_wide"),
                                        (256, "k_gather_wide")])
def test_lane_gather_matches_pallas(v4_probes, wi, kernel):
    rng = np.random.default_rng(wi)
    rows = 256 if kernel == "gk" else 128
    x = rng.integers(0, 2**31, (rows, 128), dtype=np.int32) if kernel == "gk" else \
        _words(rng, (rows, 128))
    i = rng.integers(0, 128, (rows, wi), dtype=np.int32)
    f = gk if kernel == "gk" else v4_probes.k_gather_wide
    want = _call(f, (rows, wi), x.dtype, x, i)
    got = pc.lane_gather(torch.from_numpy(x), torch.from_numpy(i))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_lane_gather_out_of_range_reads_zero():
    x = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    i = torch.tensor([[0, -1, 4, 3], [2**31 - 1, 1, 2, 0]], dtype=torch.int32)
    assert pc.lane_gather(x, i).tolist() == [[1, 0, 0, 4], [0, 6, 7, 5]]


@pytest.mark.parametrize("shape, dtype", [((128, 128), np.uint32), ((128, 128), np.int32),
                                          ((512, 128), np.uint32)])
def test_transpose_matches_pallas(v4_probes, shape, dtype):
    x = _words(np.random.default_rng(shape[0]), shape, dtype)
    want = _call(v4_probes.k_transpose, shape[::-1], dtype, x)
    got = pc.transpose(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_onehot_matmul_matches_pallas(v4_probes):
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 2, (128, w)).astype(np.float32) for w in (128, 256))
    want = _call(v4_probes.k_onehot_mm, (128, 256), jnp.float32, a.astype(jnp.bfloat16),
                 b.astype(jnp.bfloat16))
    got = pc.onehot_matmul(torch.from_numpy(a).to(torch.bfloat16),
                           torch.from_numpy(b).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, a.T @ b)  # exact


@pytest.mark.parametrize("row", [0, 317, 511])
def test_dyn_row_matches_pallas(row):
    x = _words(np.random.default_rng(row), (512, 128))
    s = np.array([row], np.int32)
    want = _call(k_dynrow, (1, 128), jnp.uint32, x, s,
                 in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                           pl.BlockSpec(memory_space=pltpu.SMEM)])
    got = pc.dyn_row(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dyn_row_out_of_range_reads_zero():
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    for r, want in ((-1, [0] * 4), (3, [0] * 4), (2, [8, 9, 10, 11])):
        assert pc.dyn_row(x, torch.tensor([r], dtype=torch.int32)).tolist() == [want]


@pytest.mark.parametrize("call, args, match", [
    (pc.onehot_matmul, (torch.zeros(16, 24, dtype=torch.bfloat16),
                        torch.zeros(16, 16, dtype=torch.bfloat16)), "multiples of 16"),
    (pc.onehot_matmul, (torch.zeros(16, 16), torch.zeros(16, 16)), "bfloat16"),
    (pc.lane_gather, (torch.zeros(4, 4, dtype=torch.int32), torch.zeros(3, 4, dtype=torch.int32)),
     "same rows"),
    (pc.lane_gather, (torch.zeros(4, 4, dtype=torch.int32), torch.zeros(4, 4, dtype=torch.int64)),
     "int32"),
    (pc.dyn_row, (torch.zeros(4, 4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)),
     "one-element"),
    (pc.transpose, (torch.zeros(4, dtype=torch.int32),), "2-D"),
])
def test_probes_reject_bad_inputs(call, args, match):
    with pytest.raises(ValueError, match=match):
        call(*args)


@pytest.mark.parametrize("n, n_pay", [(4 * LEAF, 1), (2 * LEAF, 0), (3 * LEAF + 5, 2)])
def test_sort_tiles_matches_the_leaf_stage(n, n_pay):
    """sort_tiles is measure_filter.py's upto_inblock (:562) cut at the
    4096-element leaf: each leaf row sorted, odd rows descending (the XLA
    leaf sort on keys flipped by row parity). The tile sort is unstable, so
    rows are compared after a canonical order."""
    rng = np.random.default_rng(n)
    npow = 1 << (n - 1).bit_length()
    planes = [rng.integers(0, 2**31, n, dtype=np.uint32)]
    planes[0][-40:] = planes[0][0]  # ties
    planes += [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
    padded = [np.concatenate([p, np.full(npow - n, 0xFFFFFFFF, np.uint32)]) for p in planes]
    rows = npow // LEAF
    rflip = (np.arange(rows, dtype=np.uint32) % 2 * np.uint32(0xFFFFFFFF))[:, None]
    out = jax.lax.sort([jnp.asarray(padded[0].reshape(rows, LEAF) ^ rflip),
                        *(jnp.asarray(p.reshape(rows, LEAF)) for p in padded[1:])],
                       dimension=1, num_keys=1)
    want = [(np.asarray(out[0]) ^ rflip).reshape(npow), *(np.array(o).reshape(npow)
                                                          for o in out[1:])]
    got = sort_cuda.sort_tiles([torch.from_numpy(p) for p in planes])
    assert [g.shape[0] for g in got] == [npow] * len(planes)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    canon = sort_cuda.canonical_tiles(got)
    for c, w in zip(canon, sort_cuda.canonical_tiles([torch.from_numpy(a) for a in want])):
        np.testing.assert_array_equal(c.numpy(), w.numpy())


def test_sort_tiles_one_short_tile_is_ascending():
    keys = np.array([5, 3, 9, 1, 7], np.uint32)
    (got,) = sort_cuda.sort_tiles([torch.from_numpy(keys)])
    assert got.shape[0] == sort_cuda.MIN_LEN
    assert got[:5].tolist() == [1, 3, 5, 7, 9] and int(got[5]) == 0xFFFFFFFF


def test_canonical_tiles_orders_each_tile_by_every_plane():
    k = torch.tensor([2, 1, 1, 0, 3, 3, 3, 3], dtype=torch.int32).view(torch.uint32)
    p = torch.tensor([9, 8, 7, 6, 5, 1, 4, 2], dtype=torch.int32).view(torch.uint32)
    ck, cp = sort_cuda.canonical_tiles((k, p), tile=4)
    assert ck.tolist() == [0, 1, 1, 2, 3, 3, 3, 3]
    assert cp.tolist() == [6, 7, 8, 9, 1, 2, 4, 5]


def test_probe_lowering_runs_every_probe_on_cpu(capsys):
    res = probe_lowering.run(device="cpu")
    out = capsys.readouterr().out
    assert len(res) == 10 and all(res.values())
    assert out.count("  OK   ") == 10 and "FAIL" not in out
    for name in ("transpose_512x128_u32", "gather_wide_idx", "dynrow_read", "gather_wide",
                 "bf16 one-hot matmul (128,128)^T@(128,256) f32 acc"):
        assert f"OK   {name}\n" in out


def test_probe_lowering_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_lowering.main([]) == 1


def test_probe_lowering_main_fails_on_a_fail_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(probe_lowering, "run", lambda: {"a": True, "b": False})
    assert probe_lowering.main([]) == 1
    monkeypatch.setattr(probe_lowering, "run", lambda: {"a": True})
    assert probe_lowering.main([]) == 0
