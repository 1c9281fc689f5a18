"""End-to-end parity check of the port's operators against their oracles
(counterpart of ``scripts/verify_parity.py``).

    [SF=2] [REFERENCE_SHAPES=1] python -m dpu_olap_tpu_torch.bench.verify_parity [--device cuda|cpu]

FilterGpu, SumGpu and TakeGpu against their Native (pyarrow) oracles, and
JoinGpu against pyarrow's join after a canonical sort: seeded workloads at
the requested SF, exact equality, one PASS/FAIL line per operator, then
``ALL PARITY CHECKS PASS`` or the number of failures, and exit 1 on any
mismatch. REFERENCE_SHAPES=1 takes the reference's real per-SF shapes
(BASELINE.md: filter SF*128 x 64Ki, take SF x 4Mi/512Ki, join SF x 2Mi a
side; the shapes of PARITY_RUNS.md) instead of the scaled-down defaults.
It runs on the card; ``--device cpu`` (the JAX script's FORCE_CPU=1) runs
the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .harness import card_missing, device_set


def check(sf: int, ref_shapes: bool, device: str = "cuda") -> int:
    """Run the four checks; returns the number of failures."""
    import pyarrow as pa

    from ..generator import make_filter_batches, make_join_tables, make_take_batches
    from ..operators.aggr_op import SumGpu, SumNative
    from ..operators.filter_op import FilterGpu, FilterNative
    from ..operators.join_op import JoinGpu, JoinNative
    from ..operators.take_op import TakeGpu, TakeNative

    ds = device_set(device)
    d = ds.nr_devices
    failures = 0

    def report(name, ok, detail=""):
        nonlocal failures
        print(f"{'PASS' if ok else 'FAIL'}  {name}  {detail}", flush=True)
        if not ok:
            failures += 1

    # filter
    if ref_shapes:
        nb = max(d, (sf * 128 // d) * d or d)
        batch_rows = 1 << 16
    else:
        nb = max(d, (sf * 8 // d) * d or d)
        batch_rows = 1 << 14
    table = make_filter_batches(nb, batch_rows)
    got = FilterGpu(ds, table).Prepare().Run()
    exp = FilterNative(table).Prepare().Run()
    ok = len(got) == len(exp) and all(np.array_equal(g, e) for g, e in zip(got, exp))
    report("filter", ok, f"{nb} batches x {batch_rows >> 10}Ki")

    # sum
    got_s = SumGpu(ds, table).Prepare().Run()
    exp_s = SumNative(table).Prepare().Run()
    report("sum", got_s == exp_s, f"result={got_s}")

    # take
    if ref_shapes:
        data, idx = make_take_batches(max(d, sf), 1 << 22, 1 << 19)
    else:
        data, idx = make_take_batches(nb, 1 << 14, 1 << 11)
    got_t = TakeGpu(ds, data, idx).Prepare().Run()
    exp_t = TakeNative(data, idx).Prepare().Run()
    report("take", len(got_t) == len(exp_t)
           and all(np.array_equal(g, e) for g, e in zip(got_t, exp_t)))

    # join (exact table equality after canonical sort)
    if ref_shapes:
        jb = max(d, (sf // d) * d or d)
        left, right = make_join_tables(jb, 1 << 21, 1 << 21)
    else:
        left, right = make_join_tables(nb, 1 << 12, 1 << 11)
    names = ["fk", "y", "x"]
    got_j = JoinGpu(ds, left, right).Prepare().Run()
    exp_j = JoinNative(left, right).Prepare().Run().select(names)
    gt = pa.Table.from_arrays([pa.array(got_j[n]) for n in names], names=names)
    key = [(n, "ascending") for n in names]
    report("join", gt.num_rows == exp_j.num_rows and gt.sort_by(key).equals(exp_j.sort_by(key)),
           f"{gt.num_rows} rows")

    print("ALL PARITY CHECKS PASS" if failures == 0 else f"{failures} FAILURES", flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)
    if card_missing(args.device, "verify_parity"):
        return 1
    sf = int(os.environ.get("SF", "1"))
    ref_shapes = os.environ.get("REFERENCE_SHAPES") == "1"
    return 1 if check(sf, ref_shapes, args.device) else 0


if __name__ == "__main__":
    sys.exit(main())
