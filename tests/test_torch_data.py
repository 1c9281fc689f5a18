"""Parity of the port's data layer (dpu_olap_tpu_torch) with the JAX package:
generator bytes, Table interop, uint32 handling, the u64/float plane split,
DeviceSet allocation, and the package's independence from jax."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpu_olap_tpu import generator as jgen
from dpu_olap_tpu.operators import join_op as jjoin
from dpu_olap_tpu_torch import config as tconfig
from dpu_olap_tpu_torch import generator as tgen
from dpu_olap_tpu_torch.columnar import Batch, Table
from dpu_olap_tpu_torch.operators import join_op as tjoin
from dpu_olap_tpu_torch.ops.sort_cuda import sort_bitonic
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet
from dpu_olap_tpu_torch.timer import Timers, timed

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _assert_tables_equal(jt, tt):
    assert len(jt) == len(tt)
    for jb, tb in zip(jt, tt):
        assert jb.names == tb.names
        for n in jb.names:
            a, b = np.asarray(jb[n]), tb.to_numpy()[n]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "make",
    [
        lambda g: g.make_join_tables(3, 1 << 10, 1 << 9),
        lambda g: g.make_join_tables(1, 1 << 12, 1 << 12, seed=7),
        lambda g: (g.make_filter_batches(2, 1 << 11),),
        lambda g: g.make_take_batches(2, 1 << 11, 1 << 9),
    ],
    ids=["join", "join_seed7", "filter", "take"],
)
def test_generator_matches_jax_bit_for_bit(make):
    for jt, tt in zip(make(jgen), make(tgen)):
        _assert_tables_equal(jt, tt)


def test_table_from_reference_round_trip():
    jl, _ = jgen.make_join_tables(2, 1 << 10, 1 << 10)
    tl = Table.from_reference(jl)
    _assert_tables_equal(jl, tl)
    assert not tl.is_device
    assert tl.to_arrow().equals(jl.to_arrow())
    back = Table.from_arrow(tl.to_arrow())
    _assert_tables_equal(jl, back)


def test_batch_device_columns_and_host():
    left, _ = tgen.make_join_tables(2, 256, 256, device=CPU)
    assert left.is_device and all(
        isinstance(c, torch.Tensor) and c.dtype == torch.uint32
        for b in left for c in b.columns.values()
    )
    host = left.to_host()
    assert not host.is_device
    cat = left.concat()
    assert isinstance(cat["fk"], torch.Tensor) and cat.num_rows == 512
    np.testing.assert_array_equal(cat.to_numpy()["y"], host.concat()["y"])


def test_batch_ragged_rejected():
    with pytest.raises(ValueError):
        Batch({"a": np.zeros(3, np.uint32), "b": np.zeros(4, np.uint32)})


def test_u32_round_trip_and_order_above_2_31():
    vals = np.array([0, 2**31, 0xFFFFFFFE, 5, 2**31 + 1, 2**31 - 1], np.uint32)
    b = Batch.from_numpy({"a": vals}, device=CPU)
    assert b["a"].dtype == torch.uint32
    np.testing.assert_array_equal(b.to_numpy()["a"], vals)
    (s,) = sort_bitonic((b["a"],))
    np.testing.assert_array_equal(s.numpy(), np.sort(vals))


def _wide_table(rng, nb=2, n=300):
    out = []
    for i in range(nb):
        out.append(
            jgen.Batch.from_numpy(
                {
                    "fk": rng.integers(0, 1000, n, dtype=np.uint32),
                    "u64": rng.integers(0, 2**64, n, dtype=np.uint64),
                    "i64": rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
                    "f64": rng.integers(0, 2**64, n, dtype=np.uint64).view(np.float64),
                    "f32": rng.integers(0, 2**32, n, dtype=np.uint32).view(np.float32),
                    "y": rng.integers(0, 2**32, n, dtype=np.uint32),
                }
            )
        )
    return jgen.Table(out)


def test_split_u64_table_matches_jax_and_recombines():
    jt = _wide_table(np.random.default_rng(3))
    tt = Table.from_reference(jt)
    js, jwide = jjoin._split_u64_table(jt, "fk")
    ts, twide = tjoin._split_u64_table(tt, "fk")
    assert jwide == twide and set(twide) == {"u64", "i64", "f64", "f32"}
    _assert_tables_equal(js, ts)
    cols = ts.concat().to_numpy()
    back = tjoin._recombine_u64(cols, twide)
    assert back.keys() == jjoin._recombine_u64(js.concat().to_numpy(), jwide).keys()
    orig = jt.concat().to_numpy()
    for n, a in orig.items():
        assert back[n].dtype == a.dtype
        np.testing.assert_array_equal(back[n].view(np.uint8), a.view(np.uint8))


def test_split_u64_rejects_wide_key():
    t = Table([Batch.from_numpy({"fk": np.zeros(4, np.uint64)})])
    with pytest.raises(TypeError):
        tjoin._split_u64_table(t, "fk")


def test_deviceset_allocate_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSet.allocate(1)
    with pytest.raises(RuntimeError):
        DeviceSet.allocate()


def test_deviceset_cpu_scatter_gather():
    ds = DeviceSet(torch.device("cpu"))
    assert ds.nr_devices == 1
    a = np.array([1, 2**31, 0xFFFFFFFE], np.uint32)
    t = ds.scatter(a)
    assert t.device.type == "cpu" and t.dtype == torch.uint32
    np.testing.assert_array_equal(DeviceSet.gather(t), a)
    ds.sync()


def test_config_nr_devices_env(monkeypatch):
    monkeypatch.setenv("NR_DEVICES", "3")
    assert tconfig.nr_devices() == 3
    monkeypatch.delenv("NR_DEVICES")
    monkeypatch.setenv("NR_DPUS", "2")
    assert tconfig.nr_devices() == 2
    monkeypatch.delenv("NR_DPUS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tconfig.nr_devices() == 0
    monkeypatch.setenv("SF", "8")
    assert tconfig.scale_factor() == 8
    monkeypatch.setenv("MAX_THREADS", "5")
    assert tconfig.max_threads() == 5


def test_timers_accumulate_per_rank():
    t = Timers()
    for rank in (0, 1):
        with timed(t, "phase", rank):
            pass
    assert t.rank_count("phase") == 2 and t.sum_ns("phase") >= 0
    assert t.sum_ms("missing") == 0


def test_port_imports_no_jax():
    """Every module of the port imports with jax made unimportable, and no
    module of the JAX package gets loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import dpu_olap_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import dpu_olap_tpu_torch.operators.join_op\n"
        "import dpu_olap_tpu_torch.native, dpu_olap_tpu_torch.plan\n"
        "bad = [m for m in sys.modules if m == 'dpu_olap_tpu' or m.startswith('dpu_olap_tpu.')]\n"
        "assert not bad, bad\n"
        "need = ['operators.join_op', 'operators.filter_op', 'operators.aggr_op',\n"
        "        'operators.take_op', 'ops.filter', 'ops.filter_cuda', 'ops.aggregate',\n"
        "        'ops.sum_cuda', 'ops.take', 'ops.take_cuda', 'parallel.streaming',\n"
        "        'ops.scan_cuda', 'ops.bitonic_cuda', 'ops.join', 'ops.hashing', 'ops.hashtable',\n"
        "        'ops.partition', 'ops.partition_cuda', 'ops.merge_cuda', 'parallel.shuffle',\n"
        "        'parallel.dist_join', 'parallel.partitioner', 'operators.partition_op',\n"
        "        'bench.device_time', 'bench.measure_filter', 'ops.filter_alt_cuda',\n"
        "        'ops.filter_stages', 'ops.block_ops_cuda', 'ops.probes_cuda',\n"
        "        'bench.measure_r3', 'bench.probe_lowering', 'native', 'plan']\n"
        "missing = [m for m in need if 'dpu_olap_tpu_torch.' + m not in mods]\n"
        "assert not missing, missing\n"
        "print(len(mods))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 25


def _unbound_names(source: str) -> list:
    """(line, name) of every name the source loads but binds nowhere: not
    imported, assigned, defined, a parameter or a builtin (a coarse
    undefined-name check; a local annotation counts as a load)."""
    import ast
    import builtins

    tree = ast.parse(source)
    bound = set(dir(builtins)) | {"__file__"}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            bound.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.Name) and not isinstance(node.ctx, ast.Load):
            bound.add(node.id)
        elif isinstance(node, ast.arg):
            bound.add(node.arg)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            bound.add(node.name)
    loads = [n for n in ast.walk(tree) if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)]
    return sorted({(n.lineno, n.id) for n in loads if n.id not in bound})


def test_port_has_no_undefined_names():
    """Every module of the port binds each name it uses (join_op.py once
    annotated ``List`` without importing it)."""
    assert _unbound_names("from typing import Dict\nx: List[Dict] = []\n") == [(2, "List")]
    bad = {str(p.relative_to(REPO)): _unbound_names(p.read_text())
           for p in sorted((REPO / "dpu_olap_tpu_torch").rglob("*.py"))}
    assert {k: v for k, v in bad.items() if v} == {}
