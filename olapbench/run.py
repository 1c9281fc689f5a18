"""Run one cell of the benchmark once:

    python3 -m olapbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``dpu_olap_tpu_torch``)
and ``BENCHMARK.json``. It builds the program's kernels where they are not
yet built (in ``dpu_olap_tpu_torch/_build/``), makes the cell's tables on
the device from the seed, warms up, measures for ``--seconds``, checks
every answer against the plain reference, and prints one JSON line last
on standard output, the numbers compared with their limits last on
standard error. With ``--trace 1`` the line holds the per-layer metrics
of a profiled slice of the window instead of the end-to-end ones.

It exits 1 and prints no result without enough CUDA devices, without the
program, or when a process of the run has loaded JAX or its package.
"""

import time

STARTED = time.time()  # noqa: E402 (the set-up time counts from here)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Python's compiled modules, torch's among them, are kept in the checkout
# as the kernels are: where the environment writes none (a site-packages
# without them and PYTHONDONTWRITEBYTECODE), every process would compile
# torch's sources anew, seconds of set-up that swing with the host's load.
# The first run writes them; spawned ranks take the same from the
# environment.
PYCACHE = Path(__file__).resolve().parent / "_out" / "pycache"
sys.pycache_prefix, sys.dont_write_bytecode = str(PYCACHE), False
os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

from olapbench import harness, spec  # noqa: E402

CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def _power_limit() -> str | None:
    """The first card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.cell(args.workload)
    for var, sub in CACHES.items():  # the program's kernel caches stay in the checkout
        os.environ[var] = str(spec.HERE / "_out" / "cache" / sub)
    marks = {}

    def mark(step):
        marks[step] = time.time() - STARTED

    import torch
    from dpu_olap_tpu_torch.ops import _kernels  # the program: a checkout without it fails here

    mark("imported")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    mark("devices_found")
    if have < cell.chips:
        print(f"olapbench: {args.workload} needs {cell.chips} CUDA device(s), {have} visible",
              file=sys.stderr)
        return 1
    _kernels.build()  # once, here: the ranks find it built
    mark("kernels_built")
    ctx = harness.Ctx(args.seed, args.seconds, bool(args.trace), cell.chips,
                      cell.config, cell.traffic, started=STARTED, marks=marks)
    ranks = harness.execute(ctx)
    loaded = sorted(set(harness.banned_modules()).union(*(r["banned"] for r in ranks)))
    if loaded:
        print(f"olapbench: JAX-side modules were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 1
    line = harness.result_line(cell, ctx, ranks)
    card = _power_limit()
    if card:
        line["device"]["card"] = card
    for r in ranks:
        marks = ", ".join(f"{k} {v:.3f}" for k, v in r["setup_marks"].items())
        print(f"olapbench: rank {r['rank']}: {len(r['latencies_s'])} queries in"
              f" {r['window_s']:.3f} s, peak {r['peak_bytes']} B; set-up s: {marks}",
              file=sys.stderr)
        if r["error"]:
            print(f"olapbench: rank {r['rank']} failed: {r['error']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
