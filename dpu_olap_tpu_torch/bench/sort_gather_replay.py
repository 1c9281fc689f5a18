"""Device time of the dense-pk join's two kernels as CUDA-graph replays,
beside the PyTorch call that does the same work.

    python -m dpu_olap_tpu_torch.bench.sort_gather_replay [--label NAME] [--out FILE]

At 2Mi and 16Mi rows (the dense join's shapes at SF=1 and SF=8; seed 42,
drawn on the card): ``sort_cuda.sort_bitonic`` of a random u32 key with one
payload beside ``torch.sort`` of the key's int32 view, and
``take_cuda.gather_sorted`` of 2Mi or 16Mi ascending queries (about 1/65
of them past the table) beside ``torch.index_select`` (those clipped).
Each call is captured CALLS times in one graph, each with outputs of its
own (so that no call finds the last one's outputs in L2; at 2Mi the 16 MB
of inputs stay there); a reading is the median of REPS replays over CALLS,
and the four readings of a size are taken ROUNDS times in turns (a, b, c,
d, d, c, b, a, ...), each the median of its rounds.
Before timing, the sort's keys are checked against ``torch.sort`` and the
gather against ``gather_sorted_ref``.

It calls the two wrappers only through ``sort_bitonic(planes)`` and
``gather_sorted(data, sidx)``, so the same file can time another checkout
of the package: run it by its path with that checkout first on PYTHONPATH,
and alternate the two checkouts on one card. It prints one
line a reading and, last, a JSON object of them; ``--out`` writes that
object to a file too. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from dpu_olap_tpu_torch.ops import sort_cuda, take_cuda

SEED = 42
SIZES = (1 << 21, 1 << 24)
CALLS = 10
REPS = 7
ROUNDS = 3


def replay_ms(fn) -> float:
    """Median device time of one of fn's calls, CALLS of them captured in
    one CUDA graph with their outputs kept, by CUDA events around REPS
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [fn() for _ in range(CALLS)]
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    del outs
    return float(np.median(times)) / CALLS


def _u32(n: int, gen: torch.Generator, high: int | None = None) -> torch.Tensor:
    """n random uint32 values on the card: any word, or below high."""
    if high is None:
        return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda",
                             generator=gen).view(torch.uint32)
    return torch.randint(0, high, (n,), dtype=torch.int64, device="cuda",
                         generator=gen).to(torch.uint32)


def readings(n: int) -> dict:
    """The four replay readings at n rows, after the correctness checks."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    key, pay = _u32(n, gen), _u32(n, gen)
    data = _u32(n, gen)
    sidx = torch.sort(_u32(n, gen, n + n // 64).to(torch.int64)).values.to(torch.uint32)
    key32 = key.view(torch.int32)
    idx = sidx.to(torch.int64).clamp(max=n - 1).to(torch.int32)
    data32 = data.view(torch.int32)

    got = sort_cuda.sort_bitonic((key, pay))
    want = torch.sort(key.to(torch.int64)).values
    if not torch.equal(got[0].to(torch.int64), want):
        raise SystemExit(f"sort_bitonic at n={n}: keys not sorted")
    if not torch.equal(take_cuda.gather_sorted(data, sidx)[0].view(torch.int32),
                       take_cuda.gather_sorted_ref(data, sidx)[0].view(torch.int32)):
        raise SystemExit(f"gather_sorted at n={n}: kernel != plain")

    fns = {
        "sort": lambda: sort_cuda.sort_bitonic((key, pay)),
        "torch_sort": lambda: torch.sort(key32),
        "gather": lambda: take_cuda.gather_sorted(data, sidx),
        "index_select": lambda: torch.index_select(data32, 0, idx),
    }
    got = {k: [] for k in fns}
    for r in range(ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[k].append(replay_ms(fns[k]))
    return {k: float(np.median(v)) for k, v in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name for this run, kept in the JSON")
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sort_gather_replay needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    out = {"label": args.label, "card": card, "package": sort_cuda.__file__,
           "calls": CALLS, "reps": REPS, "rounds": ROUNDS, "ms": {}}
    for n in SIZES:
        size = f"{n >> 20}Mi"
        for name, ms in readings(n).items():
            out["ms"][f"{name}_{size}"] = ms
            print(f"[{args.label}] {name} {size}: {ms:.4f} ms a call (graph replay) [{card}]",
                  flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
