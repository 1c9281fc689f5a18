"""The port's take/sum/probe/dense measurement (dpu_olap_tpu_torch.bench.
measure_r3) on the CPU at 1/1024 of its sizes: every section's candidate
names and notes, the chain steps against numpy, the command line, and that
importing the module runs nothing and writes no file."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpu_olap_tpu_torch.bench import device_time
from dpu_olap_tpu_torch.bench import measure_r3 as m3

REPO = Path(__file__).resolve().parents[1]
SHRINK = 1024


@pytest.fixture(scope="module")
def results():
    return m3.run(device="cpu", shrink=SHRINK, reps=3)


EXPECTED = {
    "take2": ["sort2op_512", "lanegather_8r", "lanegather_32r"],
    "sum": ["kernel_64Ki", "kernel_32Ki", "torch_8Ki", "kernel_8Ki"],
    "probe": ["build_sorted_1Ki", "merge_stream_1Ki", "probe_sorted_1Ki"],
    "dense": ["probe_sort_2Ki", "join_dense_2Ki"],
}
NOTES = {"take2": "/s", "sum": "GB/s", "probe": "M/s", "dense": "M"}


@pytest.mark.parametrize("section", m3.SECTIONS)
def test_section_candidates(results, section):
    got = results[section]
    assert list(got) == EXPECTED[section]
    assert all(e["ms"] > 0 and NOTES[section] in e["note"] for e in got.values())
    # the median of the reps, or the estimator's clamp where a loaded host
    # makes T(2k) - T(k) come out negative, as measure_r3 records it (s * 1e3)
    clamp_ms = device_time.CLAMP_S * 1e3
    assert all(e["spread_ms"][0] <= e["ms"] <= max(e["spread_ms"][1], clamp_ms)
               for e in got.values())


def test_full_size_names():
    """At full size the names are the JAX script's, without its TPU sweeps."""
    assert m3._tag(512 << 10) == "512Ki" and m3._tag(64 << 20) == "64Mi"
    assert m3._tag(1 << 21) == "2Mi" and m3._tag(1000) == "1000"


def test_lines_are_tagged_measure_r3(capsys):
    m3.run(["dense"], device="cpu", shrink=SHRINK, reps=1)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["[measure_r3] dense probe_sort_2Ki",
                                                  "[measure_r3] dense join_dense_2Ki"]


def _np_xor(c, *terms):
    r = c.astype(np.int64)
    for t in terms:
        r ^= t.astype(np.int64)
    return (r & 0xFFFFFFFF).astype(np.uint32)


def test_steps_match_numpy():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    y = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    tc, ty = torch.from_numpy(c), torch.from_numpy(y)
    order = np.argsort(c, kind="stable")
    np.testing.assert_array_equal(m3._sort2_step(tc, ty).numpy(),
                                  _np_xor(c[order], y[order] & 1))
    lo = np.uint32(int(c.astype(np.uint64).sum()) & 0xFFFFFFFF)
    np.testing.assert_array_equal(m3._sum_step(tc).numpy(), c ^ (lo & 1))
    np.testing.assert_array_equal(m3._torch_sum_step(tc).numpy(), c ^ (lo & 1))
    x = rng.integers(0, 2**31, (16, 128), dtype=np.int32)
    li = rng.integers(0, 128, (16, 128), dtype=np.int32)
    np.testing.assert_array_equal(m3._lane_step(torch.from_numpy(li), torch.from_numpy(x)).numpy(),
                                  np.take_along_axis(x, li, axis=1) & 127)


def test_probe_steps_match_numpy():
    rng = np.random.default_rng(1)
    n = 2000
    keys = rng.permutation(np.uint32(4 * n))[:n].astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    q = rng.integers(0, 4 * n, n, dtype=np.uint32)
    order = np.argsort(keys)
    tk, tv = torch.from_numpy(keys[order]), torch.from_numpy(vals[order])
    hit = dict(zip(keys.tolist(), vals.tolist()))
    found = np.array([int(k) in hit for k in q])
    got = np.array([hit.get(int(k), 0) for k in q], np.uint32)
    np.testing.assert_array_equal(m3._probe_step(torch.from_numpy(q), tk, tv).numpy(),
                                  _np_xor(q, got & 1, found))
    np.testing.assert_array_equal(m3._build_step(torch.from_numpy(keys), torch.from_numpy(vals))
                                  .numpy(), _np_xor(keys, keys[order] & 1, vals[order] & 2))


def test_unknown_section_raises(capsys):
    with pytest.raises(ValueError, match="unknown section 'take3'"):
        m3.run(["sum", "take3"], device="cpu", shrink=SHRINK)
    assert capsys.readouterr().out == ""


def test_import_runs_nothing():
    code = "import dpu_olap_tpu_torch.bench.measure_r3 as m; print(list(m.SECTIONS))"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(list(m3.SECTIONS))


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert m3.main(["sum"]) == 1


@pytest.mark.parametrize("argv, sections", [([], list(m3.SECTIONS)), (["probe"], ["probe"])],
                         ids=["default_all", "named"])
def test_main_writes_only_the_given_file(monkeypatch, tmp_path, argv, sections):
    calls = []
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(m3, "run", lambda s: calls.append(list(s)) or {"sum": {"x": {"ms": 1.0}}})
    r3 = REPO / "MEASURE_R3.json"
    before = r3.read_bytes()
    assert m3.main(argv) == 0 and list(tmp_path.iterdir()) == []  # no --out: no file
    out = tmp_path / "r3.json"
    assert m3.main([*argv, "--out", str(out)]) == 0
    assert calls == [sections, sections]
    assert [p.name for p in tmp_path.iterdir()] == ["r3.json"]
    assert json.loads(out.read_text()) == {"device": "card", "sum": {"x": {"ms": 1.0}}}
    assert r3.read_bytes() == before
