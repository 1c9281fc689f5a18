"""The port's filter-kernel measurement (dpu_olap_tpu_torch.bench.
measure_filter) on the CPU at a small n: every section's candidate names,
the floor flag, the chain steps, v4's numpy parity check, the ops section's
parity check, and that importing the module runs nothing."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpu_olap_tpu_torch.bench import measure_filter as mf

REPO = Path(__file__).resolve().parents[1]
SIZES = ((20_000, "20K", 2),)


@pytest.fixture(scope="module")
def results():
    return mf.run(device="cpu", sizes=SIZES, reps=3, parity_n=5000)


EXPECTED = {
    "e2e": ["v1_20K", "chain_20K", "v1_eager_20K"],
    "parts": ["copy_20K", "count_20K", "prefix_20K", "lookback_20K", "full_20K", "clone_20K"],
    "v3": ["v1_20K", "v3_20K", "v2_20K", "v1wi_20K", "v3wi_20K"],
    "v4": ["v4_20K", "v3_20K", "v1_20K", "v4wi_20K", "v1wi_20K"],
    "defaultab": ["v1_20K#0", "v3_20K#0", "v1b_20K#0", "v3b_20K#0"],
    "ops": ["lane_roll_r256x16", "row_roll_r256x16", "where_r256x16", "lane_gather_r256x16",
            "sublane_gather_r256x16"],
    "cops": ["transpose_r128x16", "sq_gather_r128x16", "count_matmul_r128x16", "cprep_r128x16"],
    "sort": ["tile_20K", "full_20K", "full1op_20K"],
}


@pytest.mark.parametrize("section", mf.SECTIONS)
def test_section_candidates(results, section):
    got = results[section]
    assert list(got) == EXPECTED[section]
    assert all(e["ms"] > 0 and "GB/s" in e["note"] for e in got.values())
    spreads = [e for name, e in got.items() if not name.startswith("v1_eager")]
    assert all(e["spread_ms"][0] <= e["ms"] <= e["spread_ms"][1] for e in spreads)


def test_run_prints_one_line_per_candidate(capsys):
    mf.run(["parts"], device="cpu", sizes=SIZES, reps=1)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[measure_filter] parts ")]
    assert len(lines) == len(EXPECTED["parts"])


def test_record_flags_a_reading_under_its_floor():
    res = {}
    nbytes = (64 << 20) * 4
    floor = nbytes / mf.ROOFLINE_BYTES_PER_S * 1e3
    low = mf.record(res, "v3", "fast", floor / 2, nbytes=nbytes)
    assert low["suspect"] and low["floor_ms"] == pytest.approx(floor)
    ok = mf.record(res, "v3", "slow", floor * 2, nbytes=nbytes)
    assert "suspect" not in ok
    tiny = mf.record(res, "v3", "tiny", 0.001)  # no bytes: the 0.004 ms floor
    assert tiny["suspect"] and tiny["floor_ms"] == mf.FLOOR_MS
    assert list(res["v3"]) == ["fast", "slow", "tiny"]


def test_chain_step_matches_numpy():
    rng = np.random.default_rng(0)
    c, out, sel = (rng.integers(0, 2**32, 1000, dtype=np.uint32) for _ in range(3))
    cnt = np.uint32(123456789)
    got = mf._mix(*(torch.from_numpy(a) for a in (c, out)), torch.tensor(int(cnt)).to(torch.uint32),
                  torch.from_numpy(sel))
    np.testing.assert_array_equal(got.numpy(), c ^ (out & 1) ^ cnt ^ (sel & 2))


def test_v4_parity_check_on_cpu(capsys):
    mf.check_v4_parity(4096 * 3 + 5, device="cpu")
    assert "parity with numpy ok" in capsys.readouterr().out


def test_unknown_section_raises(capsys):
    with pytest.raises(ValueError, match="unknown section 'sort2'"):
        mf.run(["parts", "sort2"], device="cpu", sizes=SIZES)
    assert capsys.readouterr().out == ""  # checked before any section runs


def test_import_runs_nothing():
    code = "import dpu_olap_tpu_torch.bench.measure_filter as m; print(sorted(m.SECTIONS))"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(sorted(mf.SECTIONS))


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a CUDA device")
    assert mf.main(["parts"]) == 1


@pytest.mark.parametrize("argv, sections", [
    ([], list(mf.SECTIONS)),
    (["parts", "v4"], ["parts", "v4"]),
], ids=["default_all", "named"])
def test_main_parses_sections(monkeypatch, tmp_path, argv, sections):
    """The command line as documented: no section means every section, and
    --out writes the readings with the card's name."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(mf, "run", lambda s: calls.append(list(s)) or {"parts": {"x": {"ms": 1.0}}})
    out = tmp_path / "mf.json"
    assert mf.main([*argv, "--out", str(out)]) == 0
    assert calls == [sections]
    assert json.loads(out.read_text()) == {"device": "card", "parts": {"x": {"ms": 1.0}}}


def test_ops_section_checks_parity_first(capsys):
    mf.run(["ops"], device="cpu", sizes=SIZES, reps=1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[:4] == [f"[measure_filter] ops parity {op}: True" for op in mf.PARITY_OPS]
    assert len(lines) == 4 + 5


def test_ops_parity_mismatch_raises(monkeypatch):
    from dpu_olap_tpu_torch.ops import block_ops_cuda

    real = block_ops_cuda.block_op
    def off_by_one(x, idx, op, reps):
        return real(x, idx, op, reps) ^ (op == "row_roll")

    monkeypatch.setattr(block_ops_cuda, "block_op", off_by_one)
    with pytest.raises(RuntimeError, match="ops parity FAILED: row_roll"):
        mf.run(["ops"], device="cpu", sizes=SIZES, reps=1)


def test_op_and_sort_steps_match_numpy():
    from dpu_olap_tpu_torch.ops import block_ops_cuda

    rng = np.random.default_rng(4)
    c = rng.integers(0, 2**31, 2 * 128 * 128, dtype=np.int32)
    ids = torch.from_numpy(rng.integers(0, 128, (256, 128), dtype=np.int32))
    want = block_ops_cuda.block_op_ref(torch.from_numpy(c).view(-1, 128), ids, "cprep", 16)
    got = mf._op_step("cprep")(torch.from_numpy(c), ids)
    np.testing.assert_array_equal(got.numpy(), want.view(-1).numpy() ^ 1)
    k, p = (rng.integers(0, 2**32, 5000, dtype=np.uint32) for _ in range(2))
    order = np.argsort(k, kind="stable")
    got = mf._sort_step(lambda planes: tuple(torch.from_numpy(a[order]) for a in (k, p)), 5000)(
        torch.from_numpy(k), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), k ^ (k[order] & 1) ^ (p[order] & 2))
    np.testing.assert_array_equal(mf._sort1_step(torch.from_numpy(k)).numpy(), k ^ (k[order] & 1))


def test_main_writes_only_the_given_file(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(mf, "run", lambda s: {"sort": {"x": {"ms": 1.0}}})
    before = (REPO / "MEASURE_FILTER.json").read_bytes()
    assert mf.main(["ops", "cops", "sort"]) == 0 and list(tmp_path.iterdir()) == []
    assert mf.main(["sort", "--out", "a.json"]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["a.json"]
    assert (REPO / "MEASURE_FILTER.json").read_bytes() == before
