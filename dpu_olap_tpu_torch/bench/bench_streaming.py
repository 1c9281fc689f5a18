"""Streaming-round pipeline evidence: overlap and flat throughput across SF
(counterpart of ``scripts/bench_streaming.py``).

    [ROUND_ROWS=n] python -m dpu_olap_tpu_torch.bench.bench_streaming
        [--sf 1 2 4 ...] [--op filter|sum|take] [--device cuda|cpu] [--out FILE]

Two claims to show (VERDICT items 2 and 6):
  1. Copy/compute overlap: the pipeline's wall time is less than the sum of
     its serialized phases (host staging + dispatch + collect), because
     staging runs one round ahead on a background thread while the device
     works (parallel/streaming.py; the reference's async rank-callback
     chains, host/dpuext/dpuext.hpp:859-899).
  2. Working-set scaling: rows/s stays about flat as SF grows, because
     rounds stream through a bounded device residency
     (FLAGS.stream_round_rows, which ROUND_ROWS sets).

For each SF, after one warm-up Run() of the operator (FilterGpu, SumGpu or
TakeGpu at the JAX script's shapes), one timed Run() on fresh Timers gives
a record: ``op``, ``sf``, ``devices``, ``backend``, ``rounds``, ``rows``,
``wall_ms``, ``rows_per_s``, ``stage_ms``, ``dispatch_ms``, ``collect_ms``,
``serialized_ms`` and ``overlap_saved_ms`` (serialized - wall), and with
one round a ``note`` that no overlap is possible. Records are appended to
``STREAMING_EVIDENCE_torch.json`` at the repository root, or ``--out``;
the JAX script's STREAMING_EVIDENCE.json is never written. It runs on the
card; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from .harness import card_missing, device_set, sync

REPO = Path(__file__).resolve().parents[2]
PHASES = ("stage", "dispatch", "collect")


def _operator(op: str, sf: int, ds):
    """The operator at the JAX script's shapes (the suite's BM_Filter,
    BM_Aggr small-batch and BM_Take tables) and its input rows."""
    from ..operators.aggr_op import SumGpu
    from ..operators.filter_op import FilterGpu
    from ..operators.take_op import TakeGpu
    from .run_benchmarks import filter_table, sum_table, take_tables

    d = ds.nr_devices
    if op == "filter":
        table = filter_table(sf, d)
        return FilterGpu(ds, table), table.num_rows
    if op == "sum":
        table = sum_table(sf, d, small=True)
        return SumGpu(ds, table), table.num_rows
    data, idx = take_tables(sf, d)
    return TakeGpu(ds, data, idx), idx.num_rows


def measure(op_name: str, sf: int, ds) -> dict:
    """One record: a warm-up Run(), then a timed Run() on fresh Timers."""
    from ..timer import Timers

    op, rows = _operator(op_name, sf, ds)
    op.Prepare()
    sync(op.Run())  # warm: kernel builds, the allocator, the runtime
    op.timers = Timers()
    t0 = time.perf_counter()
    sync(op.Run())
    wall = time.perf_counter() - t0
    phases = {f"{p}_ms": op.Timers().sum_ms(p) for p in PHASES}
    serialized = sum(phases.values())
    rec = {
        "op": op_name,
        "sf": sf,
        "devices": ds.nr_devices,
        "backend": ds.device.type,
        # rounds dispatched, from the timers (SumGpu keeps no round count;
        # the JAX script reports 1 for it)
        "rounds": op.Timers().rank_count("dispatch"),
        "rows": rows,
        "wall_ms": wall * 1e3,
        "rows_per_s": rows / wall,
        **phases,
        "serialized_ms": serialized,
        "overlap_saved_ms": serialized - wall * 1e3,
    }
    if rec["rounds"] == 1:
        # a single round has nothing to overlap: serialized == pipelined
        # work and the difference is timer noise (it can be negative)
        rec["note"] = "rounds=1: no overlap possible; delta is noise"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--op", default="filter", choices=["filter", "sum", "take"])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the kernels' plain versions")
    ap.add_argument("--out", help="append the records here instead")
    args = ap.parse_args(argv)
    if card_missing(args.device, "bench_streaming"):
        return 1
    from ..config import FLAGS

    if os.environ.get("ROUND_ROWS"):
        FLAGS.stream_round_rows = int(os.environ["ROUND_ROWS"])
    ds = device_set(args.device)
    out = Path(args.out) if args.out else REPO / "STREAMING_EVIDENCE_torch.json"
    records = json.loads(out.read_text()) if out.exists() else []
    for sf in args.sf:
        rec = measure(args.op, sf, ds)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    out.write_text(json.dumps(records, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
