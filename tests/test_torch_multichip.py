"""The port's several-device entry points (dpu_olap_tpu_torch.bench.multichip),
as tests/test_graft.py guards the JAX package's: dryrun_multichip(4) on CPU
shards in a fresh process with a bare environment prints every "ok" line of
the JAX dry run; without a CUDA device the card's path raises and the
command exits 1; the weak-scaling line carries bench_multichip.py's keys."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dpu_olap_tpu_torch.bench import multichip

REPO = Path(__file__).resolve().parents[1]
OK_LINES = (
    "flat mesh ok",
    "hierarchical 2x2 mesh ok",
    "hierarchical multi-round ok (rounds=2)",
    "skewed-key join ok",
    "host-staged multi-round path ok",
    "device-resident multi-round join ok",
    "resident repartition ok",
)


def test_dryrun_fresh_process_no_env(tmp_path):
    r = subprocess.run(
        [sys.executable, "-c",
         "from dpu_olap_tpu_torch.bench.multichip import dryrun_multichip;"
         " dryrun_multichip(4, device='cpu')"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path),
             "OMP_NUM_THREADS": "1"},  # one core: other test workers share the machine
    )
    assert r.returncode == 0, r.stderr[-800:]
    assert "4 shards on 1 physical device (cpu)" in r.stdout
    for line in OK_LINES:
        assert f"dryrun_multichip(4): {line}" in r.stdout, r.stdout


def test_card_path_needs_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip.dryrun_multichip(2)
    assert multichip.main(["--dryrun", "2"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    # shards go round the visible cards, repeating them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    ds = multichip.device_set(4)
    assert [d.index for d in ds.devices] == [0, 1, 0, 1] and len(ds.physical) == 2


def test_weak_scaling_line_keys(tmp_path, capsys):
    out = tmp_path / "mc.json"
    assert multichip.main(["--device", "cpu", "--devices", "2", "--rows-per-dev", "4096",
                           "--curve", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["devices"] == 2 and res["physical_devices"] == 1 and res["platform"] == "cpu"
    for key in ("single_rows_per_s", "multi_rows_per_s", "weak_scaling_efficiency",
                "host_cores", "exchange_copies", "exchange_bytes"):
        assert key in res
    assert [p["devices"] for p in res["curve"]] == [1, 2]
    assert [p["devices"] for p in res["local_curve_no_collectives"]] == [1, 2]
    assert res["curve"][0]["weak_scaling_efficiency"] == 1.0
    # two sides, planes and counts apart: 4 exchanges of a cat a destination
    assert res["exchange_copies"] == 8 and res["exchange_bytes"] > 0
    assert set(res["attribution"]) == {"d2"}
    assert set(res["attribution"]["d2"]["phase_ms"]) == {"fragments-ms", "exchange-ms",
                                                         "local-join-ms"}
