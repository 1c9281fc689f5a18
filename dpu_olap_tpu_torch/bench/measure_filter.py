"""The filter kernels' A/B and stage ablation, the in-block primitive probes
and the sort's stage split on the card (counterpart of
``scripts/measure_filter.py``, sections ``e2e``, ``parts``, ``v3``, ``v4``,
``defaultab``, ``ops``, ``cops`` and ``sort``).

    python -m dpu_olap_tpu_torch.bench.measure_filter [SECTION ...] [--out FILE]

  e2e       v1 (``ops/filter_cuda.py``) at 8Mi and 64Mi; beside it the chain
            step alone (``chain``) and v1's chain run eagerly (``v1_eager``,
            the launch gap).
  parts     v1's own one-sweep kernel cut at a stage
            (``ops/filter_stages.py``: copy, count, prefix, lookback, full;
            each one memset and one sweep launch on v1's ticket, launch
            bounds and grid, full adding the tail pass; 8n bytes each) at
            8Mi, interleaved with ``torch.clone`` (``clone``), the pure-IO
            yardstick of the copy stage. The differences between
            consecutive stages split v1's time: IO, predicate and count,
            rank and staging, look-back, tail.
  v3        v1 against v3 and v2, and v1 against v3 with indices,
            interleaved, at 8Mi and 64Mi.
  v4        v4's parity with numpy on the card at 2Mi first, then v4
            against v3 and v1, with and without indices, interleaved.
  defaultab v1 against v3 twice over (v1, v3, v1b, v3b), interleaved.
  ops       the in-block primitives (``ops/block_ops_cuda.py`` OPS) on 64
            (256, 128) int32 blocks, 2Mi elements, 16 chained in a call:
            the kernel first held against its plain version on one block at
            2 ops (lane_gather, lane_roll, row_roll, sublane_gather; a
            mismatch raises), then each op timed, interleaved.
  cops      the same for COPS on 128 (128, 128) tiles.
  sort      the TPU sort's tile stage (``sort_cuda.sort_tiles``, a
            bitonic network, key + 1 payload), the whole sort (``full``,
            a radix sort, which has no tile stage: ``tile`` is no longer a
            part of ``full``) and the key-only sort (``full1op``) at 2Mi.

Inputs are random from ``np.random.default_rng(0)``, as in the JAX script.
A filter step is the filter on the carry, then ``c ^ (out & 1) ^ cnt`` (``^
(sel & 2)`` with indices); an ops/cops step is the op's call on the carry
with idx as a const, then ``^ 1``; a sort step ``c ^ (a & 1) ^ (b & 2)``.
Each is timed by ``bench/device_time.py`` (CUDA graphs, (T(2k) - T(k)) /
k). Names follow the JAX script's without its TPU block geometry (``r256``,
``h4``), except ops/cops' ``{op}_r256x16``, whose block shape is part of
the function. The JAX script's ``leaf{2048,4096,8192}`` readings and its
``sort2`` section sweep only the TPU's leaf and ``block_rows``, which have
no counterpart here. Each reading prints one line and lands in the returned
dict; one under its floor (4n bytes at the H100's 3.35 TB/s, or 0.004 ms)
is flagged ``suspect``. A JSON file is written only with ``--out``. It runs
on the card; ``device="cpu"`` and small ``sizes`` exist for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

ROOFLINE_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FLOOR_MS = 0.004
SECTIONS = ("e2e", "parts", "v3", "v4", "defaultab", "ops", "cops", "sort")
REPS = 5
PARITY_N = 2 << 20
LANES = 128
OP_REPS = 16  # chained ops in one ops/cops call (the JAX script's reps)
PARITY_REPS = 2
PARITY_OPS = ("lane_gather", "lane_roll", "row_roll", "sublane_gather")
# (n, tag, k) for each section, the JAX script's sizes and chain lengths
SIZES = {
    "e2e": ((8 << 20, "8Mi", 64), (64 << 20, "64Mi", 8)),
    "parts": ((8 << 20, "8Mi", 32),),
    "v3": ((8 << 20, "8Mi", 32), (64 << 20, "64Mi", 4)),
    "v4": ((8 << 20, "8Mi", 32), (64 << 20, "64Mi", 4)),
    "defaultab": ((8 << 20, "8Mi", 32), (64 << 20, "64Mi", 8)),
    "ops": ((2 << 20, "2Mi", 16),),
    "cops": ((2 << 20, "2Mi", 16),),
    "sort": ((2 << 20, "2Mi", 16),),
}


def record(results: dict, section: str, name: str, ms: float, note: str = "",
           nbytes: int | None = None, spread_ms: list | None = None,
           script: str = "measure_filter") -> dict:
    """Keep one reading under results[section][name] and print it, tagged
    with ``script``; flag it ``suspect`` when it lies under its floor."""
    entry = {"ms": ms, "note": note}
    if spread_ms:
        entry["spread_ms"] = [min(spread_ms), max(spread_ms)]
    floor_ms = FLOOR_MS
    if nbytes is not None:
        floor_ms = max(floor_ms, nbytes / ROOFLINE_BYTES_PER_S * 1e3)
    if ms < floor_ms:
        entry["suspect"] = True
        entry["floor_ms"] = floor_ms
        print(f"[{script}] {section} {name}: {ms:.6f} ms BELOW FLOOR {floor_ms:.4f}", flush=True)
    else:
        spread = f" (reps {entry['spread_ms'][0]:.4f}-{entry['spread_ms'][1]:.4f})" if spread_ms else ""
        print(f"[{script}] {section} {name}: {ms:.4f} ms{spread}  {note}", flush=True)
    results.setdefault(section, {})[name] = entry
    return entry


def _values(n: int, device: str, seed: int = 0):
    import torch

    a = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)
    return torch.from_numpy(a).to(device)


def _mix(c, out, cnt, sel=None):
    """c ^ (out & 1) ^ cnt [^ (sel & 2)], in int32 bits."""
    import torch

    r = c.view(torch.int32) ^ (out.view(torch.int32) & 1) ^ cnt.view(torch.int32)
    if sel is not None:
        r = r ^ (sel.view(torch.int32) & 2)
    return r.view(torch.uint32)


def _cstep(f):
    return lambda c: _mix(c, *f(c))


def _wstep(f):
    def step(c):
        out, sel, cnt = f(c)
        return _mix(c, out, cnt, sel)
    return step


def _stage_step(stage):
    from ..ops import filter_stages

    def step(c):
        out, _, cnt = filter_stages.filter_stage(c, stage)
        return _mix(c, out, cnt)
    return step


def _steps():
    from ..ops import filter_alt_cuda, filter_cuda

    def alt(f, version):
        return lambda c: f(c, version)

    return {
        "v1": _cstep(filter_cuda.filter_compact),
        **{v: _cstep(alt(filter_alt_cuda.filter_compact, v)) for v in ("v2", "v3", "v4")},
        "v1wi": _wstep(filter_cuda.filter_with_indices),
        **{f"{v}wi": _wstep(alt(filter_alt_cuda.filter_with_indices, v)) for v in ("v3", "v4")},
    }


def _ab(results, section, cands, sizes, device, reps, suffix=""):
    """Time the candidates, (name, step) pairs of _steps(), interleaved at
    each size and record them as {name}_{tag}{suffix}."""
    from .device_time import time_chained_multi

    steps = _steps()
    for n, tag, k in sizes:
        x = _values(n, device)
        specs = [(f"{name}_{tag}{suffix}", steps[kind], x, k) for name, kind in cands]
        spread = {}
        res = time_chained_multi(specs, reps=reps, spread=spread)
        for name, sec in res.items():
            record(results, section, name, sec * 1e3, f"{n * 4 / sec / 1e9:.0f} GB/s",
                   nbytes=n * 4, spread_ms=[s * 1e3 for s in spread[name]])
        del x
    return results[section]


def measure_e2e(results, device="cuda", sizes=SIZES["e2e"], reps=REPS):
    """v1 and the chain step alone, interleaved; v1's chain run eagerly."""
    import torch

    from ..ops import filter_cuda
    from .device_time import time_chained, time_chained_multi

    v1 = _cstep(filter_cuda.filter_compact)
    for n, tag, k in sizes:
        x = _values(n, device)
        zero = torch.zeros((), dtype=torch.uint32, device=device)
        spread = {}
        res = time_chained_multi([(f"v1_{tag}", v1, x, k),
                                  (f"chain_{tag}", lambda c: _mix(c, c, zero), x, k)],
                                 reps=reps, spread=spread)
        res[f"v1_eager_{tag}"] = time_chained(v1, x, k=k, reps=reps, graph=False)
        for name, sec in res.items():
            record(results, "e2e", name, sec * 1e3, f"{n * 4 / sec / 1e9:.0f} GB/s",
                   nbytes=n * 4, spread_ms=[s * 1e3 for s in spread.get(name, ())])
        del x
    return results["e2e"]


def measure_parts(results, device="cuda", sizes=SIZES["parts"], reps=REPS):
    """v1's kernel cut at each stage and torch.clone, interleaved."""
    import torch

    from ..ops.filter_stages import STAGES
    from .device_time import time_chained_multi

    for n, tag, k in sizes:
        x = _values(n, device)
        zero = torch.zeros((), dtype=torch.uint32, device=device)
        spread = {}
        specs = [(f"{s}_{tag}", _stage_step(s), x, k) for s in STAGES]
        specs.append((f"clone_{tag}", lambda c: _mix(c, c.clone(), zero), x, k))
        res = time_chained_multi(specs, reps=reps, spread=spread)
        for name, sec in res.items():
            record(results, "parts", name, sec * 1e3, f"{n * 4 / sec / 1e9:.0f} GB/s",
                   nbytes=n * 4, spread_ms=[s * 1e3 for s in spread[name]])
        del x
    return results["parts"]


def measure_v3(results, device="cuda", sizes=SIZES["v3"], reps=REPS):
    cands = [(c, c) for c in ("v1", "v3", "v2", "v1wi", "v3wi")]
    return _ab(results, "v3", cands, sizes, device, reps)


def check_v4_parity(n: int = PARITY_N, device: str = "cuda") -> None:
    """v4 with and without indices against numpy, on ``device``."""
    import torch

    from ..ops import filter_alt_cuda

    thr = 1 << 30
    xs = np.random.default_rng(7).integers(0, 2**32, n, dtype=np.uint32)
    ref, refi = xs[xs < thr], np.flatnonzero(xs < thr).astype(np.uint32)
    x = torch.from_numpy(xs).to(device)
    out, cnt = filter_alt_cuda.filter_compact(x, "v4", thr)
    c = int(cnt)
    if c != len(ref) or not np.array_equal(out.cpu().numpy()[:c], ref):
        raise RuntimeError("v4 compact device parity FAILED")
    _, sel, c2 = filter_alt_cuda.filter_with_indices(x, "v4", thr)
    if int(c2) != len(ref) or not np.array_equal(sel.cpu().numpy()[: int(c2)], refi):
        raise RuntimeError("v4 with_indices device parity FAILED")
    print(f"[measure_filter] v4 parity with numpy ok (n={n}, on {device})", flush=True)


def measure_v4(results, device="cuda", sizes=SIZES["v4"], reps=REPS, parity_n=PARITY_N):
    check_v4_parity(parity_n, device)
    cands = [(c, c) for c in ("v4", "v3", "v1", "v4wi", "v1wi")]
    return _ab(results, "v4", cands, sizes, device, reps)


def measure_defaultab(results, device="cuda", sizes=SIZES["defaultab"], reps=REPS):
    run_id = len([k for k in results.get("defaultab", {}) if k.startswith(f"v1_{sizes[0][1]}")])
    cands = [("v1", "v1"), ("v3", "v3"), ("v1b", "v1"), ("v3b", "v3")]
    return _ab(results, "defaultab", cands, sizes, device, reps, suffix=f"#{run_id}")


def _i32(rng, n, hi):
    """n random int32 in [0, hi) from rng, as numpy."""
    return rng.integers(0, hi, n, dtype=np.int32)


def check_ops_parity(x, idx) -> None:
    """The gather and roll ops against their plain versions at PARITY_REPS,
    on x's device (measure_filter.py:467-482 holds the TPU kernel to
    interpret mode the same way)."""
    import torch

    from ..ops import block_ops_cuda as bo

    for op in PARITY_OPS:
        got = bo.block_op(x, idx, op, PARITY_REPS)
        ok = torch.equal(got, bo.block_op_ref(x, idx, op, PARITY_REPS))
        print(f"[measure_filter] ops parity {op}: {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"ops parity FAILED: {op} kernel != plain")


def _op_step(op):
    from ..ops import block_ops_cuda as bo

    def step(c, ids):
        return bo.block_op(c.view(-1, LANES), ids, op, OP_REPS).view(-1) ^ 1
    return step


def _block_ops(results, section, ops, device, sizes, reps):
    """Each op on nblk blocks of its (rows, 128) shape, OP_REPS to a call,
    interleaved; the ops section checks parity on one block first."""
    import torch

    from ..ops.block_ops_cuda import ROWS
    from .device_time import time_chained_multi

    rows = ROWS[ops[0]]
    for n, tag, k in sizes:
        nblk = max(1, n // (rows * LANES))
        n = nblk * rows * LANES
        rng = np.random.default_rng(0)
        if section == "ops":
            block = [torch.from_numpy(_i32(rng, (rows, LANES), hi)).to(device)
                     for hi in (2**31, LANES)]
            check_ops_parity(*block)
        xs = torch.from_numpy(_i32(rng, n, 2**31)).to(device)
        ids = torch.from_numpy(_i32(rng, n, LANES)).to(device).view(-1, LANES)
        spread = {}
        specs = [(f"{op}_r{rows}x{OP_REPS}", _op_step(op), xs, k, (ids,)) for op in ops]
        res = time_chained_multi(specs, reps=reps, spread=spread)
        for name, sec in res.items():
            per_pass = sec / OP_REPS
            record(results, section, name, sec * 1e3,
                   f"{n * 4 / per_pass / 1e9:.0f} GB/s per pass"
                   f" ({per_pass * 1e6:.2f} us/pass/{tag})",
                   nbytes=n * 4, spread_ms=[s * 1e3 for s in spread[name]])
        del xs, ids
    return results[section]


def measure_ops(results, device="cuda", sizes=SIZES["ops"], reps=REPS):
    from ..ops.block_ops_cuda import OPS

    return _block_ops(results, "ops", OPS, device, sizes, reps)


def measure_cops(results, device="cuda", sizes=SIZES["cops"], reps=REPS):
    from ..ops.block_ops_cuda import COPS

    return _block_ops(results, "cops", COPS, device, sizes, reps)


def _sort_step(sort, n):
    import torch

    def step(c, p):
        a, b = sort((c, p))
        r = c.view(torch.int32) ^ (a[:n].view(torch.int32) & 1) ^ (b[:n].view(torch.int32) & 2)
        return r.view(torch.uint32)
    return step


def _sort1_step(c):
    import torch

    from ..ops.sort_cuda import sort_bitonic

    (a,) = sort_bitonic((c,))
    return (c.view(torch.int32) ^ (a.view(torch.int32) & 1)).view(torch.uint32)


def measure_sort(results, device="cuda", sizes=SIZES["sort"], reps=REPS):
    """The tile stage, the whole sort and the key-only sort, interleaved."""
    import torch

    from ..ops.sort_cuda import sort_bitonic, sort_tiles
    from .device_time import time_chained_multi

    for n, tag, k in sizes:
        rng = np.random.default_rng(0)
        key = torch.from_numpy(rng.integers(0, 2**31, n, dtype=np.uint32)).to(device)
        pay = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(device)
        specs = [(f"tile_{tag}", _sort_step(sort_tiles, n), key, k, (pay,)),
                 (f"full_{tag}", _sort_step(sort_bitonic, n), key, k, (pay,)),
                 (f"full1op_{tag}", _sort1_step, key, k)]
        nbytes = {f"tile_{tag}": 8 * n, f"full_{tag}": 8 * n, f"full1op_{tag}": 4 * n}
        spread = {}
        res = time_chained_multi(specs, reps=reps, spread=spread)
        for name, sec in res.items():
            record(results, "sort", name, sec * 1e3,
                   f"{n / sec / 1e6:.0f} M/s, {nbytes[name] / sec / 1e9:.0f} GB/s",
                   nbytes=nbytes[name], spread_ms=[s * 1e3 for s in spread[name]])
        del key, pay
    return results["sort"]


def run(sections=SECTIONS, device: str = "cuda", sizes=None, reps: int = REPS,
        parity_n: int = PARITY_N) -> dict:
    """Run the named sections; ``sizes`` ((n, tag, k), ...) replaces every
    section's own. Returns {section: {name: reading}}."""
    bad = [s for s in sections if s not in SECTIONS]
    if bad:
        raise ValueError(f"unknown section {bad[0]!r}; sections are {SECTIONS}")
    results: dict = {}
    for s in sections:
        kw = {"device": device, "sizes": sizes or SIZES[s], "reps": reps}
        if s == "v4":
            kw["parity_n"] = parity_n
        globals()[f"measure_{s}"](results, **kw)
    return results


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*", metavar="SECTION",
                    help=f"any of {' '.join(SECTIONS)} (default: all)")
    ap.add_argument("--out", help="also write the readings to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_filter needs a CUDA device", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    results = run(args.sections or SECTIONS)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": card, **results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
