"""The port's operator suite and the entry points beside it
(dpu_olap_tpu_torch.bench.run_benchmarks, verify_parity, bench_streaming,
devicecount) on the CPU: every entry's row at 1/1024 of the reference's
lengths, each operator entry's result against the JAX package's operator on
the same seed-42 columns and against its pyarrow oracle, the parity
checker's PASS and FAIL, the streaming record, the command lines without a
card, and that importing a module runs nothing."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpu_olap_tpu.columnar import Batch as JaxBatch
from dpu_olap_tpu.columnar import Table as JaxTable
from dpu_olap_tpu.operators import FilterTpu, JoinTpu, PartitionTpu, SumTpu, TakeTpu
from dpu_olap_tpu.parallel.mesh import DeviceSet as JaxDeviceSet
from dpu_olap_tpu_torch.bench import bench_streaming, devicecount, verify_parity
from dpu_olap_tpu_torch.bench import run_benchmarks as rb
from dpu_olap_tpu_torch.operators import PartitionGpu
from dpu_olap_tpu_torch.operators.aggr_op import SumGpu, SumNative
from dpu_olap_tpu_torch.operators.filter_op import FilterGpu, FilterNative
from dpu_olap_tpu_torch.operators.join_op import JoinGpu, JoinNative
from dpu_olap_tpu_torch.operators.take_op import TakeGpu, TakeNative
from dpu_olap_tpu_torch.ops.hashing import bucket_shift, wang_hash_np
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

REPO = Path(__file__).resolve().parents[1]
SHRINK = 1024
CPU_SET = DeviceSet(torch.device("cpu"))
NEW_MODULES = ("harness", "run_benchmarks", "verify_parity", "bench_streaming", "devicecount")
OUTPUTS = ("bench_results.json", "STREAMING_EVIDENCE.json")


@pytest.fixture(scope="module")
def rows():
    return rb.run(device="cpu", shrink=SHRINK, tag="t")


def test_every_entry_has_a_row(rows):
    """Every entry of the JAX suite, in its order; filter_kernel, as in the
    JAX suite off its device, only on the card."""
    assert [r["name"] for r in rows] == [n for n in rb.ENTRIES if n != "filter_kernel"]
    src = Path(rb.__file__).read_text()
    names = set(re.findall(r'(?:record|chained)\(\s*"(\w+)"', src))
    assert set(rb.STEPS) <= names <= set(rb.ENTRIES)


def test_rows_carry_rates_backend_and_spread(rows):
    for r in rows:
        assert r["items_per_s"] > 0 and r["real_ms"] > 0, r["name"]
        assert r["bytes_per_s"] == pytest.approx(4 * r["items_per_s"])
        assert r["backend"] == "cpu" and r["devices"] == 1 and r["sf"] == 1 and r["tag"] == "t"
        assert np.isfinite(r["spread_pct"]) and r["spread_pct"] >= 0


def test_device_pairing(rows):
    by = {r["name"]: r for r in rows}
    for op, kn in rb.DEVICE_PAIRS.items():
        if kn in by:
            assert by[op]["device_ms"] == by[kn]["real_ms"]
            assert by[op]["device_items_per_s"] == by[kn]["items_per_s"]
            assert by[op]["device_glue_ms"] == by[kn]["glue_ms"]
        else:  # filter_kernel: on the card only
            assert "device_ms" not in by[op]
    assert "device_ms" not in by["sum_native"]


def test_chained_rows_carry_their_glue(rows):
    """Every chained row times its step's glue alone beside it; no other
    row has a glue time."""
    for r in rows:
        if r["name"] in rb.STEPS:
            assert np.isfinite(r["glue_ms"]) and r["glue_ms"] > 0, r["name"]
        else:
            assert "glue_ms" not in r, r["name"]
    assert {r["name"] for r in rows if "glue_ms" in r} == set(rb.STEPS) - {"filter_kernel"}


def test_filter_selects_entries(capsys):
    got = rb.run("memcpy|sum_native_small", device="cpu", shrink=SHRINK)
    assert [r["name"] for r in got] == ["sum_native_small", "parallel_memcpy_t2",
                                        "parallel_memcpy_t4", "parallel_memcpy_t8",
                                        "parallel_memcpy_t16"]
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(ln) for ln in lines] == got


def _jax(table):
    return JaxTable([JaxBatch.from_numpy(b.to_numpy()) for b in table])


def _chunks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _join_rows(cols):
    rows = np.stack([np.asarray(cols[c]) for c in ("fk", "y", "x")])
    return rows[:, np.lexsort(rows[::-1])]


def _partition_oracle(table, p):
    a = np.concatenate([b["a"] for b in table])
    q = wang_hash_np(a) >> np.uint32(bucket_shift(p))
    return [a[q == i] for i in range(p)]


@pytest.mark.parametrize("entry", ["filter_tpu", "sum_tpu", "sum_tpu_small", "take_tpu",
                                   "take_tpu_small", "partition_tpu", "partition_tpu_host",
                                   "join_tpu"])
def test_operator_entry_matches_jax_and_its_oracle(entry):
    """The operator that the entry times, on the suite's inputs at the
    shrunk lengths, against the JAX package's on the same columns and
    against the entry's *_native oracle."""
    jds = JaxDeviceSet.allocate(1)
    if entry == "filter_tpu":
        t = rb.filter_table(1, shrink=SHRINK)
        got = FilterGpu(CPU_SET, t).Prepare().Run()
        _chunks_equal(got, FilterTpu(jds, _jax(t)).Prepare().Run())
        _chunks_equal(got, FilterNative(t).Prepare().Run())
    elif entry.startswith("sum_tpu"):
        t = rb.sum_table(1, shrink=SHRINK, small=entry.endswith("small"))
        got = SumGpu(CPU_SET, t).Prepare().Run()
        assert got == SumTpu(jds, _jax(t)).Prepare().Run() == SumNative(t).Prepare().Run()
    elif entry.startswith("take_tpu"):
        data, idx = rb.take_tables(1, shrink=SHRINK, small=entry.endswith("small"))
        got = TakeGpu(CPU_SET, data, idx).Prepare().Run()
        _chunks_equal(got, TakeTpu(jds, _jax(data), _jax(idx)).Prepare().Run())
        _chunks_equal(got, TakeNative(data, idx).Prepare().Run())
    elif entry.startswith("partition_tpu"):
        t, nb = rb.partition_table(1, shrink=SHRINK)
        resident = None if entry == "partition_tpu" else False
        parts = PartitionGpu(CPU_SET, t, "a", nb, resident=resident).Prepare().Run()
        jparts = PartitionTpu(jds, _jax(t), "a", nb, resident=resident).Prepare().Run()
        if resident is None:
            parts, jparts = parts.to_host(), jparts.to_host()
        assert len(parts) == len(jparts) == nb
        for g, w, o in zip(parts, jparts, _partition_oracle(t, nb)):
            np.testing.assert_array_equal(g["a"], np.asarray(w["a"]))
            np.testing.assert_array_equal(g["a"], o)
    else:
        left, right = rb.join_tables(1, shrink=SHRINK)
        got = _join_rows(JoinGpu(CPU_SET, left, right).Prepare().Run())
        jout = JoinTpu(jds, _jax(left), _jax(right)).Prepare().Run()
        np.testing.assert_array_equal(got, _join_rows(jout))
        nat = JoinNative(left, right).Prepare().Run()
        nat_cols = {c: nat[c].to_numpy() for c in ("fk", "y", "x")}
        np.testing.assert_array_equal(got, _join_rows(nat_cols))


def test_workload_shapes_at_full_size_are_the_references():
    """The row counts of the JAX suite at SF=1 and SF=2 on one device (no
    data made: only the arithmetic of the shapes)."""
    assert rb._per_device_batches(1, 1) == 1 and rb._per_device_batches(2, 1) == 2
    t = rb.filter_table(1, batch_shift=4)
    assert len(t) == 128 and t[0].num_rows == 16
    data, idx = rb.take_tables(1, shrink=1 << 12)
    assert (len(data), data[0].num_rows, idx[0].num_rows) == (1, 1 << 10, 1 << 7)
    left, _ = rb.join_tables(2, shrink=1 << 11)
    assert (len(left), left[0].num_rows) == (2, 1 << 10)


def test_chained_steps_keep_their_carry():
    rng = np.random.default_rng(3)
    n = 4096
    c = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32))
    pay = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32))
    out = rb.step("partition_kernel_p8")(c, pay, 1024)
    assert out.dtype == torch.uint32 and out.shape == c.shape
    assert ((out.to(torch.int64) ^ c.to(torch.int64)) & ~1).eq(0).all()  # bit 0 only
    lo = int(c.to(torch.int64).sum()) & 0xFFFFFFFF
    hi = int(c.to(torch.int64).sum()) >> 32
    np.testing.assert_array_equal(rb.step("sum_kernel")(c).numpy(), c.numpy() ^ np.uint32(lo ^ hi))
    idx = torch.from_numpy(rng.integers(0, n, 512, dtype=np.uint32).astype(np.int32))
    want = idx.numpy() ^ (c.numpy()[idx.numpy()] & 1).astype(np.int32)
    np.testing.assert_array_equal(rb.step("take_kernel")(idx, c).numpy(), want)
    np.testing.assert_array_equal(rb.step("take_rowgather_kernel")(idx, c).numpy(), want)
    # the rehash in int32 equals the JAX suite's uint32 one
    v = c.numpy()
    with np.errstate(over="ignore"):
        want_h = ((v ^ np.uint32(61)) ^ (v >> np.uint32(16))) * np.uint32(0x27D4EB2D)
    np.testing.assert_array_equal(rb._rehash(c.view(torch.int32)).numpy(), want_h)
    # the join step flips bit 0 of each fk: every key stays in the pk range
    left, right = rb.join_tables(1, shrink=SHRINK)
    lf, ly = torch.from_numpy(left[0]["fk"]), torch.from_numpy(left[0]["y"])
    rk, rx = torch.from_numpy(right[0]["pk"]), torch.from_numpy(right[0]["x"])
    per = lf.shape[0]
    nxt = rb.step("join_kernel")(lf, ly, rk, rx)
    assert ((nxt.to(torch.int64) ^ lf.to(torch.int64)) & ~1).eq(0).all()
    assert int(nxt.to(torch.int64).max()) < per


def test_main_writes_only_its_file(tmp_path, monkeypatch):
    before = _outputs()
    out = tmp_path / "rows.json"
    assert rb.main(["--device", "cpu", "--filter", "sum_native$", "--tag", "x",
                    "--out", str(out)]) == 0
    got = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["name"] for r in got] == ["sum_native"] and got[0]["tag"] == "x"
    assert rb.output_path(".*", "x").name == "bench_results_torch.json"
    assert rb.output_path("sum", "x").name == "bench_results_torch_x.json"
    assert _outputs() == before


def test_verify_parity_passes_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setenv("SF", "1")
    monkeypatch.delenv("REFERENCE_SHAPES", raising=False)
    assert verify_parity.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines[:4]] == [["PASS", n] for n in
                                                     ("filter", "sum", "take", "join")]
    assert lines[4:] == ["ALL PARITY CHECKS PASS"]


def test_verify_parity_fails_on_a_wrong_filter(capsys, monkeypatch):
    run = FilterGpu.Run

    def wrong(self):
        chunks = run(self)
        chunks[0] = chunks[0][1:]
        return chunks

    monkeypatch.setattr(FilterGpu, "Run", wrong)
    monkeypatch.setenv("SF", "1")
    assert verify_parity.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("FAIL  filter") and "1 FAILURES" in out
    assert "ALL PARITY CHECKS PASS" not in out


STREAM_KEYS = ["op", "sf", "devices", "backend", "rounds", "rows", "wall_ms", "rows_per_s",
               "stage_ms", "dispatch_ms", "collect_ms", "serialized_ms", "overlap_saved_ms"]


def test_bench_streaming_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ROUND_ROWS", str(1 << 16))
    from dpu_olap_tpu_torch.config import FLAGS

    monkeypatch.setattr(FLAGS, "stream_round_rows", FLAGS.stream_round_rows)
    out = tmp_path / "se.json"
    out.write_text(json.dumps([{"old": 1}]))  # records are appended
    assert bench_streaming.main(["--device", "cpu", "--op", "sum", "--sf", "1",
                                 "--out", str(out)]) == 0
    assert FLAGS.stream_round_rows == 1 << 16  # ROUND_ROWS read into the flag
    recs = json.loads(out.read_text())
    assert recs[0] == {"old": 1} and len(recs) == 2
    rec = recs[1]
    assert list(rec)[:len(STREAM_KEYS)] == STREAM_KEYS
    assert rec["op"] == "sum" and rec["backend"] == "cpu" and rec["rows"] == 32 << 16
    assert rec["serialized_ms"] == pytest.approx(rec["stage_ms"] + rec["dispatch_ms"]
                                                 + rec["collect_ms"])
    assert rec["overlap_saved_ms"] == pytest.approx(rec["serialized_ms"] - rec["wall_ms"])
    assert rec["rounds"] == 32 and "note" not in rec  # 32 x 64Ki at 64Ki rows a round
    assert json.loads(capsys.readouterr().out) == rec


@pytest.mark.parametrize("op, rows", [("sum", 32 << 16), ("take", 1 << 19)])
def test_bench_streaming_one_round_is_noted(op, rows):
    rec = bench_streaming.measure(op, 1, CPU_SET)
    assert rec["rounds"] == 1 and rec["rows"] == rows
    assert rec["note"] == "rounds=1: no overlap possible; delta is noise"


def _outputs():
    """The suite's and the JAX suite's output files at the repository root,
    with their bytes."""
    names = [*OUTPUTS, *(p.name for p in REPO.glob("bench_results_torch*.json")),
             "STREAMING_EVIDENCE_torch.json"]
    return {n: (REPO / n).read_bytes() if (REPO / n).exists() else None for n in names}


@pytest.mark.parametrize("module, argv", [(rb, []), (rb, ["--filter", "sum"]),
                                          (verify_parity, []), (bench_streaming, ["--sf", "1"]),
                                          (devicecount, [])])
def test_entry_points_need_a_card(module, argv, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    before = _outputs()
    assert module.main(argv) != 0
    assert "CUDA device" in capsys.readouterr().err
    assert _outputs() == before
    assert list(tmp_path.iterdir()) == []


def test_run_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rb.run("sum_native", device="cuda", shrink=SHRINK)


def test_module_command_line_exits_nonzero_without_a_card():
    """The command line with every card hidden, whatever the machine has."""
    before = _outputs()
    res = subprocess.run([sys.executable, "-m", "dpu_olap_tpu_torch.bench.run_benchmarks",
                          "--filter", "memcpy"], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 1 and res.stdout == "" and "CUDA device" in res.stderr
    assert _outputs() == before


def test_import_runs_nothing(tmp_path):
    code = "".join(f"import dpu_olap_tpu_torch.bench.{m}\n" for m in NEW_MODULES)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    assert res.stdout == "" and list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("module", NEW_MODULES)
def test_sources_import_no_jax(module):
    src = (REPO / "dpu_olap_tpu_torch" / "bench" / f"{module}.py").read_text()
    assert re.search(r"^(import torch|from \.harness import)", src, re.M)
    assert not re.search(r"\bjax\b", re.sub(r"#.*|\"\"\"[\s\S]*?\"\"\"", "", src))
    assert not re.search(r"dpu_olap_tpu(?!_torch)\b", re.sub(r"\"\"\"[\s\S]*?\"\"\"", "", src))
