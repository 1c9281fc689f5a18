"""Run() and its host staging of the streaming operators, and the plan
chains' run times, on the card.

    python dpu_olap_tpu_torch/bench/staging.py --label change --out staging.json

For FilterGpu (BM_Filter, SF*128 batches of 64Ki), SumGpu (BM_Aggr: SF x 2Mi
and SF*32 x 64Ki) and TakeGpu (BM_Take: SF x 4Mi data, 512Ki queries) at
SF=1 and SF=8, seed 42: the median of REPS Run() calls (host clock, the card
synchronised before the start and after the end, each on a fresh
operator after one warm-up run) and, of the same runs, the median Timers()
ms of ``stage`` (the round's host staging), ``dispatch`` and ``collect``.
Where the checkout has the query plan (``dpu_olap_tpu_torch.plan``), the
same for each plan chain of chip_smoke.py's phase_plan (a fresh plan a
run): Aggregate(Filter(Source)) at SF=1 and SF=8, the materialized Filter, the
fused filter join and an Aggregate over it, the bare join (JoinGpu's dense
route) and the device-resident Filter -> HashJoin -> Aggregate on
BM_JoinDpu SF=1, Aggregate(TakeNode) on BM_Take SF=1, and Repartition of
the BM_JoinDpu SF=8 probe table into 16 partitions. Results are not checked
here (chip_smoke.py does); the card's name and power limit go with them.

To compare two checkouts in one call, run the script by its path with each
checkout on PYTHONPATH in turns (a checkout without the plan times only the
operators). Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 42
SFS = (1, 8)
REPS = 3  # timed runs a reading (median)
PHASES = ("stage", "dispatch", "collect")


def _sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def operator_readings(ds, sf: int) -> dict:
    """{label: {"run_ms", "<phase>_ms"...}} of FilterGpu, SumGpu and TakeGpu."""
    from dpu_olap_tpu_torch.generator import make_filter_batches, make_take_batches
    from dpu_olap_tpu_torch.operators.aggr_op import SumGpu
    from dpu_olap_tpu_torch.operators.filter_op import FilterGpu
    from dpu_olap_tpu_torch.operators.take_op import TakeGpu

    data, idx = make_take_batches(sf, 1 << 22, 1 << 19, seed=SEED)
    ops = {
        f"filter SF={sf}": (lambda t=make_filter_batches(sf * 128, 1 << 16, seed=SEED):
                            FilterGpu(ds, t)),
        f"sum SF={sf} {sf}x2Mi": (lambda t=make_filter_batches(sf, 1 << 21, seed=SEED):
                                  SumGpu(ds, t)),
        f"sum SF={sf} {sf * 32}x64Ki": (lambda t=make_filter_batches(sf * 32, 1 << 16, seed=SEED):
                                        SumGpu(ds, t)),
        f"take SF={sf}": lambda: TakeGpu(ds, data, idx),
    }
    out = {}
    for label, make in ops.items():
        make().Prepare().Run()  # warm-up: kernel build, allocator
        runs = []
        for _ in range(REPS):
            op = make().Prepare()
            runs.append((_sync_ms(op.Run), {p: op.Timers().sum_ms(p) for p in PHASES}))
        out[label] = {"run_ms": float(np.median([r for r, _ in runs])),
                      **{f"{p}_ms": float(np.median([ph[p] for _, ph in runs])) for p in PHASES}}
    return out


def plan_readings(ds) -> dict:
    """{label: {"run_ms"}} of the plan chains (see the module note)."""
    from dpu_olap_tpu_torch import plan as P
    from dpu_olap_tpu_torch.generator import (
        make_filter_batches, make_join_tables, make_take_batches,
    )

    left, right = make_join_tables(1, 1 << 21, 1 << 21, seed=SEED)
    left8, _ = make_join_tables(8, 1 << 21, 1 << 21, seed=SEED)
    data, idx = make_take_batches(1, 1 << 22, 1 << 19, seed=SEED)
    f1 = make_filter_batches(128, 1 << 16, seed=SEED)

    def device_chain():
        fnode = P.Filter(P.Source(left), "y")
        fnode._run(ds)  # materialized: the join takes its device columns
        return P.Aggregate(P.HashJoin(fnode, P.Source(right)), "x").scalar(ds)

    chains = {
        **{f"plan Aggregate(Filter(Source)) SF={sf}": (
            lambda t=make_filter_batches(sf * 128, 1 << 16, seed=SEED):
            P.Aggregate(P.Filter(P.Source(t), "a"), "a").scalar(ds)) for sf in SFS},
        "plan Filter(Source) SF=1": lambda: P.Filter(P.Source(f1), "a").execute(ds),
        "plan HashJoin(Filter, Source) SF=1": lambda: P.HashJoin(
            P.Filter(P.Source(left), "y"), P.Source(right)).execute(ds),
        "plan Aggregate(HashJoin(Filter, Source)) SF=1": lambda: P.Aggregate(
            P.HashJoin(P.Filter(P.Source(left), "y"), P.Source(right)), "x").scalar(ds),
        "plan HashJoin(Source, Source) SF=1": lambda: P.HashJoin(
            P.Source(left), P.Source(right)).execute(ds),
        "plan device chain SF=1": device_chain,
        "plan Aggregate(TakeNode) SF=1": lambda: P.Aggregate(
            P.TakeNode(P.Source(data), P.Source(idx)), "a").scalar(ds),
        "plan Repartition SF=8 P=16": lambda: P.Repartition(P.Source(left8), "fk", 16).execute(ds),
    }
    out = {}
    for label, run in chains.items():
        run()  # warm-up
        out[label] = {"run_ms": float(np.median([_sync_ms(run) for _ in range(REPS)]))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name for this run, kept in the JSON")
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("staging needs a CUDA device", file=sys.stderr)
        return 1
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ds = DeviceSet.allocate(1)
    ms = {}
    for sf in SFS:
        ms.update(operator_readings(ds, sf))
    if importlib.util.find_spec("dpu_olap_tpu_torch.plan") is not None:
        ms.update(plan_readings(ds))
    import dpu_olap_tpu_torch

    out = {"label": args.label, "card": card, "package": dpu_olap_tpu_torch.__file__,
           "reps": REPS, "ms": ms}
    for label, r in ms.items():
        body = ", ".join(f"{k} {v:.3f}" for k, v in r.items())
        print(f"[{args.label}] {label}: {body} (median of {REPS}) [{card}]", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
