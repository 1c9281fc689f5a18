#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (dpu_olap_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from dpu_olap_tpu_torch/csrc, checks each kernel
against its plain PyTorch version on the card, then drives the main path —
the BM_JoinDpu dense-pk join through JoinGpu.Prepare().Run() — at SF=1
(checked against the pyarrow oracle) and SF=8 (checked against the dense
truth), with the kernels' launch counts read around each run. It prints one
line per phase, a JSON line with each kernel's numbers, and last
{"ok": true, "device": {...}}. With no CUDA device, outside the repository,
or when any phase fails, it exits non-zero and prints no "ok" line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 42
SF1_ROWS = 1 << 21  # rows per side of one BM_JoinDpu batch
SF8 = 8
REPS = 7  # timed runs per kernel measurement (median)


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0].strip()


def main() -> dict:
    import torch

    print(f"[env] torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    card = card_line()
    print(f"[env] card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # imported only now: a copy of this script outside the repo fails here
    from dpu_olap_tpu_torch.generator import make_join_tables
    from dpu_olap_tpu_torch.operators.join_op import JoinGpu, JoinNative
    from dpu_olap_tpu_torch.ops import _kernels, merge, sort_cuda, take_cuda
    from dpu_olap_tpu_torch.parallel.mesh import DeviceSet

    def cuda_ms(fn) -> float:
        """Median device time of fn over REPS runs, by CUDA events."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return float(np.median(times))

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def canon(cols) -> np.ndarray:
        rows = np.stack([np.asarray(c) for c in cols])
        return rows[:, np.lexsort(rows[::-1])]

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.library()
    built = _kernels.build_seconds
    print(
        f"[build] {so.name}: nvcc {'%.2f s' % built if built is not None else 'cached'}, "
        f"ready in {time.perf_counter() - t0:.2f} s",
        flush=True,
    )

    # ---- 3. uint32 glue ops on the card -----------------------------------
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    a[:4] = [0, 2**31, 0xFFFFFFFE, 0xFFFFFFFF]
    ta = on_card(a)
    require(ta.dtype == torch.uint32 and np.array_equal(host(ta), a), "uint32 H2D/D2H round trip")
    a64 = ta.to(torch.int64)
    require(np.array_equal(host(a64), a.astype(np.int64)), "uint32 -> int64")
    lo = 123456789
    wrapped = merge._u32(a64 - lo)
    require(np.array_equal(host(wrapped), a - np.uint32(lo)), "wrapping u32 subtraction")
    mask = a64 < 2**31
    require(np.array_equal(host(mask), a < 2**31), "int64 compare above 2^31")
    require(
        np.array_equal(host(merge._where0(mask, ta)), np.where(a < 2**31, a, 0)),
        "uint32 where via int32 view",
    )
    order = torch.sort(a64, stable=True).indices
    require(
        np.array_equal(host(ta.view(torch.int32)[order].view(torch.uint32)), np.sort(a)),
        "int64 sort + int32-view index",
    )
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    flag |= torch.zeros((), dtype=torch.int32, device=dev)
    require(flag.item() == 0, "int32 flag or-reduce")
    print("[glue] uint32 glue ops on the card agree with numpy", flush=True)

    # ---- 4. kernels against their plain versions, on the card -------------
    def sort_case(n: int, n_pay: int):
        key = rng.integers(0, 0xFFFFFFFF, n, dtype=np.uint32)  # < 0xFFFFFFFF
        pool = rng.integers(0, 0xFFFFFFFF, 1000, dtype=np.uint32)
        dup = rng.choice(n, n // 4, replace=False)
        key[dup] = pool[rng.integers(0, len(pool), len(dup))]  # many duplicates
        pays = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_pay)]
        planes = tuple(on_card(p) for p in (key, *pays))
        got = [host(t) for t in sort_cuda.sort_bitonic(planes)]
        ref = [host(t) for t in sort_cuda.sort_bitonic_ref(planes)]
        require(np.array_equal(ref[0], np.sort(key)), f"plain sort n={n}")
        require(np.array_equal(got[0], ref[0]), f"sort keys n={n} payloads={n_pay}")
        g, r = canon(got), canon(ref)
        require(np.array_equal(g, r), f"sort rows n={n} payloads={n_pay}")
        require(np.array_equal(r, canon([key, *pays])), f"plain sort rows n={n}")
        err = int(np.abs(g.astype(np.int64) - r.astype(np.int64)).max())
        return planes, err

    sort_err = 0
    timed_planes = None
    for n in (SF1_ROWS, 3 * (1 << 20) + 17):
        for n_pay in (1, 3):
            planes, err = sort_case(n, n_pay)
            sort_err = max(sort_err, err)
            print(f"[sort] n={n} payloads={n_pay}: kernel == plain", flush=True)
            if n == SF1_ROWS and n_pay == 1:
                timed_planes = planes  # the main path's shape: (idx, y)
    for n in (2, 1000, 5000):  # padded to MIN_LEN, one tile, two tiles
        sort_err = max(sort_err, sort_case(n, 2)[1])
    print("[sort] n=2, 1000, 5000 payloads=2: kernel == plain", flush=True)
    sort_ms = cuda_ms(lambda: sort_cuda.sort_bitonic(timed_planes))
    sort_plain_ms = cuda_ms(lambda: sort_cuda.sort_bitonic_ref(timed_planes))
    print(
        f"[sort] n={SF1_ROWS} 1 payload: kernel {sort_ms:.4f} ms, plain {sort_plain_ms:.4f} ms"
        f" (median of {REPS}, CUDA events) [{card}]",
        flush=True,
    )

    n = SF1_ROWS
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    sidx = np.sort(rng.integers(0, n + n // 64, n).astype(np.uint32))  # tail out of range
    tdata, tsidx = on_card(data), on_card(sidx)
    gv, gf = take_cuda.gather_sorted(tdata, tsidx)
    rv, _ = take_cuda.gather_sorted_ref(tdata, tsidx)
    gv, rv = host(gv), host(rv)
    expect = np.where(sidx < n, data[np.minimum(sidx, n - 1)], 0).astype(np.uint32)
    require(np.array_equal(rv, expect), "plain gather")
    require(np.array_equal(gv, rv) and gf.item() == 0, "gather kernel == plain")
    gather_err = int(np.abs(gv.astype(np.int64) - rv.astype(np.int64)).max())
    gather_ms = cuda_ms(lambda: take_cuda.gather_sorted(tdata, tsidx))
    gather_plain_ms = cuda_ms(lambda: take_cuda.gather_sorted_ref(tdata, tsidx))
    print(
        f"[gather] {n} sorted queries into {n} rows: kernel == plain; kernel {gather_ms:.4f} ms,"
        f" plain {gather_plain_ms:.4f} ms (median of {REPS}, CUDA events) [{card}]",
        flush=True,
    )

    def run_join(num_batches: int):
        """Drive the main path once with fresh launch counts; then time it."""
        left, right = make_join_tables(num_batches, SF1_ROWS, SF1_ROWS, seed=SEED)
        ds = DeviceSet.allocate(1)
        op = JoinGpu(ds, left, right).Prepare()
        require(op.pk_dense, "generator pk not detected dense")
        sort_cuda.LAUNCHES = 0
        take_cuda.LAUNCHES = 0
        out = op.Run()
        launches = {"sort": sort_cuda.LAUNCHES, "gather": take_cuda.LAUNCHES}
        require(
            launches["sort"] > 0 and launches["gather"] > 0,
            f"main path did not launch every kernel: {launches}",
        )
        secs, phases = [], {}
        for _ in range(3):
            op_t = JoinGpu(ds, left, right).Prepare()
            torch.cuda.synchronize()
            t = time.perf_counter()
            op_t.Run()
            secs.append(time.perf_counter() - t)
            for name in ("host-prep", "h2d", "join-total", "gather-result"):
                phases.setdefault(name, []).append(op_t.Timers().sum_ms(name))
        run_s = float(np.median(secs))
        phase_ms = {k: float(np.median(v)) for k, v in phases.items()}
        return left, right, out, launches, run_s, phase_ms

    def device_path(left, right):
        """Device time of join_shard_dense on device-resident inputs, and of
        its two kernels alone at the same shapes."""
        lf, rt = left.concat(), right.concat()
        fk, y, pk, x = (on_card(lf["fk"]), on_card(lf["y"]), on_card(rt["pk"]), on_card(rt["x"]))
        total = cuda_ms(lambda: merge.join_shard_dense(fk, (y,), pk, (x,)))
        idx = merge._u32(fk.to(torch.int64) - pk[:1].to(torch.int64))
        s_ms = cuda_ms(lambda: sort_cuda.sort_bitonic((idx, y)))
        sidx_ = sort_cuda.sort_bitonic((idx, y))[0]
        g_ms = cuda_ms(lambda: take_cuda.gather_sorted(x, sidx_))
        return total, s_ms, g_ms

    # ---- 5. main path, flagship shape (SF=1) --------------------------------
    left, right, out, launches1, run_s, phase_ms = run_join(1)
    nat = JoinNative(left, right).Prepare().Run()
    cols = ("fk", "y", "x")
    require(len(out["fk"]) == nat.num_rows, "SF=1 row count differs from pyarrow")
    require(
        np.array_equal(canon([out[c] for c in cols]), canon([nat[c].to_numpy() for c in cols])),
        "SF=1 JoinGpu != JoinNative",
    )
    rows = len(out["fk"])
    dev_ms, dsort_ms, dgather_ms = device_path(left, right)
    print(
        f"[join SF=1] {rows} rows == pyarrow; launches {launches1}; Run() {run_s * 1e3:.3f} ms ="
        f" {rows / run_s:.1f} rows/s (median of 3; phases ms {phase_ms});"
        f" device join_shard_dense {dev_ms:.4f} ms = {rows / (dev_ms / 1e3):.1f} rows/s"
        f" (sort {dsort_ms:.4f} ms, gather {dgather_ms:.4f} ms) [{card}]",
        flush=True,
    )

    # ---- 6. main path, real size (SF=8, one concatenated join) -------------
    torch.cuda.reset_peak_memory_stats(dev)
    left, right, out, launches8, run_s8, phase_ms8 = run_join(SF8)
    peak = torch.cuda.max_memory_allocated(dev)
    lc, rc = left.concat(), right.concat()
    pk0 = int(rc["pk"][0])
    fk_out = out["fk"].astype(np.int64)
    require(len(fk_out) == lc.num_rows, "SF=8 row count != left rows")
    require(np.array_equal(out["x"], rc["x"][fk_out - pk0]), "SF=8 x != right_x[fk - pk0]")
    require(
        np.array_equal(canon([out["fk"], out["y"]]), canon([lc["fk"], lc["y"]])),
        "SF=8 (fk, y) multiset differs from the input",
    )
    rows8 = len(fk_out)
    dev_ms8, dsort_ms8, dgather_ms8 = device_path(left, right)
    print(
        f"[join SF=8] {rows8} rows == dense truth; launches {launches8}; Run() {run_s8 * 1e3:.3f} ms ="
        f" {rows8 / run_s8:.1f} rows/s (median of 3; phases ms {phase_ms8}); peak device memory"
        f" {peak} B; device join_shard_dense {dev_ms8:.4f} ms = {rows8 / (dev_ms8 / 1e3):.1f} rows/s"
        f" (sort {dsort_ms8:.4f} ms, gather {dgather_ms8:.4f} ms) [{card}]",
        flush=True,
    )

    kernels = [
        {
            "name": "sort_bitonic",
            "route": "cuda",
            "source": "dpu_olap_tpu_torch/csrc/sort.cu",
            "replaces": "dpu_olap_tpu/ops/sort_pallas.py:385",
            "replaces_kernels": [
                "dpu_olap_tpu/ops/sort_pallas.py:286",
                "dpu_olap_tpu/ops/sort_pallas.py:103",
                "dpu_olap_tpu/ops/sort_pallas.py:327",
            ],
            "launches": launches1["sort"],
            "max_abs_err": sort_err,
            "ms": sort_ms,
            "plain_ms": sort_plain_ms,
        },
        {
            "name": "gather_sorted",
            "route": "cuda",
            "source": "dpu_olap_tpu_torch/csrc/gather.cu",
            "replaces": "dpu_olap_tpu/ops/take_pallas.py:219",
            "launches": launches1["gather"],
            "max_abs_err": gather_err,
            "ms": gather_ms,
            "plain_ms": gather_plain_ms,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[card] {card}", flush=True)
    return {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }


if __name__ == "__main__":
    try:
        result = main()
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
    except Exception:
        traceback.print_exc()
        print("FAIL: chip_smoke raised", flush=True)
        sys.exit(1)
    print(json.dumps(result), flush=True)
