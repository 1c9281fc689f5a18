"""The take, sum, probe and dense-join measurements on the card (counterpart
of ``scripts/measure_r3.py``, sections ``take2``, ``sum``, ``probe``,
``dense`` and ``take``).

    python -m dpu_olap_tpu_torch.bench.measure_r3 [take2 sum probe dense take] [--out FILE]

  take2  the 2-plane sort of 512Ki indices and their positions
         (``sort2op_512Ki``, k = 32), then the lane gather
         (``ops/probes_cuda.lane_gather``, the JAX script's ``gk``) on
         (8192, 128) and (32768, 128) int32 planes, chained on the index
         plane as ``lane_gather(x, c) & 127`` (k = 256).
  sum    the exact-sum kernel (``ops/sum_cuda.sum_u64_pair``) at 64Mi and
         32Mi (k = 32), and at 8Mi (k = 512) interleaved with
         ``x.sum(dtype=torch.int64)`` (``torch_8Mi``, the counterpart of the
         JAX script's ``xla_8Mi``).
  probe  the sorted-store hash table at 1Mi keys: its build
         (``build_sorted_1Mi``), the merge-probe stream of sorted queries
         (``merge_stream_1Mi``) and the probe (``probe_sorted_1Mi``), k = 8,
         interleaved.
  dense  the probe-side sort (``probe_sort_2Mi``) and the dense-pk join
         (``join_dense_2Mi``, ``ops/merge.join_shard_dense``) at 2Mi a side,
         k = 8, interleaved.
  take   the port's row gather (``ops/take.take``, ``rowgather_*``) beside
         ``torch.index_select`` (``index_select_*``), 512Ki indices, k = 8,
         each pair interleaved, in rows (or indices) a second: row width 8,
         16, 32, 64 and 128 over a 16 MB table (``w{W}_16MB``); tables of 1
         to 32 MB at width 128 (``{M}MB_w128``); random against sorted row
         indices (``rand_16MB_w128``, ``sorted_16MB_w128``); the element
         gather of 1-D data at random against sorted indices
         (``elemgather_rand_16MB``, ``elemgather_sorted_16MB`` beside
         ``index_select_{rand,sorted}_16MB``). Each row step keeps every
         gathered column live through a row sum, as the JAX script does.

Seeds, sizes and chain lengths are the JAX script's; each step feeds its
result back as in that script. Timing is ``bench/device_time.py``'s (CUDA
graphs, (T(2k) - T(k)) / k); readings go through measure_filter's
``record`` (the H100 floor, the ``suspect`` flag). Not ported: the TPU's
``leaf`` sweep of take2 and ``pallas_r{256..4096}`` sweep of sum and
``wr`` sweep of dense (they size only the TPU's grid), take's
``sorted_hint`` reading (XLA's ``indices_are_sorted`` lowering: the port's
row gather has no such hint), and the sections ``take3``, ``take4`` and
``dense2`` (the TPU gather's window and slice, which the port's gather has
not). A JSON file is written only with ``--out``; the
JAX script's MEASURE_R3.json is never touched. It runs on the card;
``device="cpu"`` and ``shrink`` (every length divided by it) exist for the
tests.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops.hashtable import SortedTable, ht_build_sorted, ht_probe_sorted
from ..ops.merge import join_shard_dense
from ..ops.merge_cuda import merge_probe
from ..ops.probes_cuda import lane_gather
from ..ops.sort_cuda import sort_bitonic
from ..ops.sum_cuda import sum_u64_pair
from ..ops.take import take
from .device_time import time_chained_multi
from .measure_filter import record

SECTIONS = ("take2", "sum", "probe", "dense", "take")
REPS = 5
LANES = 128


def _tag(n: int) -> str:
    if n >= 1 << 20 and n % (1 << 20) == 0:
        return f"{n >> 20}Mi"
    if n >= 1 << 10 and n % (1 << 10) == 0:
        return f"{n >> 10}Ki"
    return str(n)


def _dev(a: np.ndarray, device: str):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _i32(t):
    return t.view(torch.int32)


def _u32(t):
    return t.view(torch.uint32)


def _timed(results, section, specs, nbytes, note, reps):
    """Time the (name, step, x, k, consts) specs interleaved and record
    each with its bytes and note(name, seconds)."""
    spread = {}
    res = time_chained_multi(specs, reps=reps, spread=spread)
    for name, sec in res.items():
        record(results, section, name, sec * 1e3, note(name, sec), nbytes=nbytes[name],
               spread_ms=[s * 1e3 for s in spread[name]], script="measure_r3")


def _sort2_step(c, pos):
    k, p = sort_bitonic((c, pos))
    return _u32(_i32(k) ^ (_i32(p) & 1))


def _lane_step(c, x):
    return lane_gather(x, c) & (LANES - 1)


def measure_take2(results, device="cuda", shrink=1, reps=REPS):
    rng = np.random.default_rng(42)
    n_idx = (512 << 10) // shrink
    idx = _dev(rng.integers(0, (4 << 20) // shrink, n_idx, dtype=np.uint32), device)
    pos = torch.arange(n_idx, device=device).to(torch.uint32)
    name = f"sort2op_{_tag(n_idx)}"
    _timed(results, "take2", [(name, _sort2_step, idx, 32, (pos,))], {name: n_idx * 8},
           lambda _, sec: f"{n_idx / sec / 1e6:.0f} M/s", reps)
    del idx, pos
    for rows in (8192 // shrink, 32768 // shrink):
        x = _dev(rng.integers(0, 2**31, (rows, LANES), dtype=np.int32), device)
        li = _dev(rng.integers(0, LANES, (rows, LANES), dtype=np.int32), device)
        nb = rows * LANES * 4
        name = f"lanegather_{rows}r"
        _timed(results, "take2", [(name, _lane_step, li, 256, (x,))], {name: 2 * nb},
               lambda _, sec: (f"{3 * nb / sec / 1e9:.0f} GB/s rwr,"
                               f" {rows * LANES / sec / 1e6:.0f} M idx/s"), reps)
        del x, li
    return results["take2"]


def _sum_step(c):
    lo, _ = sum_u64_pair(c)
    return _u32(_i32(c) ^ (_i32(lo) & 1))


def _torch_sum_step(c):
    s = c.sum(dtype=torch.int64)
    return _u32(_i32(c) ^ (s & 1).to(torch.int32))


def measure_sum(results, device="cuda", shrink=1, reps=REPS):
    gbs = {}

    def note(name, sec):
        return f"{gbs[name] / sec / 1e9:.0f} GB/s"

    for nbig in ((64 << 20) // shrink, (32 << 20) // shrink):
        xb = _dev(np.random.default_rng(1).integers(0, 2**32, nbig, dtype=np.uint32), device)
        name = f"kernel_{_tag(nbig)}"
        gbs[name] = nbig * 4
        _timed(results, "sum", [(name, _sum_step, xb, 32)], gbs, note, reps)
        del xb
    n = (8 << 20) // shrink
    x = _dev(np.random.default_rng(0).integers(0, 2**32, n, dtype=np.uint32), device)
    specs = [(f"torch_{_tag(n)}", _torch_sum_step, x, 512),
             (f"kernel_{_tag(n)}", _sum_step, x, 512)]
    gbs.update({name: n * 4 for name, *_ in specs})
    _timed(results, "sum", specs, gbs, note, reps)
    return results["sum"]


def _build_step(c, vals):
    t = ht_build_sorted(c, vals)
    return _u32(_i32(c) ^ (_i32(t.keys) & 1) ^ (_i32(t.values) & 2))


def _merge_step(c, tkeys, tvals):
    has, _, (pv,) = merge_probe(c, tkeys, (tvals,))
    return _u32(_i32(c) ^ (_i32(pv) & 1) ^ has.to(torch.int32))


def _probe_step(c, tkeys, tvals):
    got, found = ht_probe_sorted(SortedTable(tkeys, tvals), c)
    return _u32(_i32(c) ^ (_i32(got) & 1) ^ found.to(torch.int32))


def measure_probe(results, device="cuda", shrink=1, reps=REPS):
    rng = np.random.default_rng(42)
    n = (1 << 20) // shrink
    keys = rng.permutation(np.uint32(4 * n))[:n].astype(np.uint32)
    vals = _dev(rng.integers(0, 2**32, n, dtype=np.uint32), device)
    q = rng.integers(0, 4 * n, n, dtype=np.uint32)
    keys_d = _dev(keys, device)
    t = ht_build_sorted(keys_d, vals)
    tag = _tag(n)
    specs = [(f"build_sorted_{tag}", _build_step, keys_d, 8, (vals,)),
             (f"merge_stream_{tag}", _merge_step, _dev(np.sort(q), device), 8, (t.keys, t.values)),
             (f"probe_sorted_{tag}", _probe_step, _dev(q, device), 8, (t.keys, t.values))]
    _timed(results, "probe", specs, {name: n * 8 for name, *_ in specs},
           lambda _, sec: f"{n / sec / 1e6:.0f} M/s", reps)
    return results["probe"]


def _dense_sort_step(c, y):
    k, p = sort_bitonic((c, y))
    return _u32(_i32(k) ^ (_i32(p) & 1))


def _dense_join_step(c, y, pk, x):
    key, (yo,), (xo,), m, ovf = join_shard_dense(c, (y,), pk, (x,))
    r = _i32(c) ^ (_i32(key) & 1) ^ (_i32(yo) & 2) ^ (_i32(xo) & 4) ^ m.to(ovf.dtype) ^ ovf
    return _u32(r)


def measure_dense(results, device="cuda", shrink=1, reps=REPS):
    rng = np.random.default_rng(42)
    per = (1 << 21) // shrink
    fk = _dev(rng.integers(0, per, per, dtype=np.uint32), device)
    y = _dev(rng.integers(0, 2**32, per, dtype=np.uint32), device)
    pk = torch.arange(per, device=device).to(torch.uint32)
    x = _dev(rng.integers(0, 2**32, per, dtype=np.uint32), device)
    tag = _tag(per)
    specs = [(f"probe_sort_{tag}", _dense_sort_step, fk, 8, (y,)),
             (f"join_dense_{tag}", _dense_join_step, fk, 8, (y, pk, x))]
    _timed(results, "dense", specs, {specs[0][0]: per * 8, specs[1][0]: per * 16},
           lambda name, sec: f"{per / sec / 1e6:.0f} M{' rows' if 'join' in name else ''}/s", reps)
    return results["dense"]


def _row_step(c, tbl):
    rows = take(tbl, c)
    return c ^ (rows.view(torch.int32).sum(dim=1, dtype=torch.int64) & 1).to(torch.int32)


def _index_select_row_step(c, tbl32):
    rows = torch.index_select(tbl32, 0, c)
    return c ^ (rows.sum(dim=1, dtype=torch.int64) & 1).to(torch.int32)


def _elem_step(c, data):
    return c ^ (take(data, c).view(torch.int32) & 1)


def _index_select_elem_step(c, data32):
    return c ^ (torch.index_select(data32, 0, c) & 1)


def measure_take(results, device="cuda", shrink=1, reps=REPS):
    """The JAX script's measure_take (scripts/measure_r3.py:98-180): the
    row gather's rate against row width, table size and index order, and
    the element gather's against index order; each reading of the port's
    gather in turns with torch.index_select's on the same indices."""
    rng = np.random.default_rng(42)
    n_idx = (512 << 10) // shrink
    n_data = (4 << 20) // shrink

    def pair(name, tbl, idx, nbytes, what="rows"):
        tbl32 = tbl.view(torch.int32)
        row = tbl.dim() == 2
        specs = [(f"{'rowgather' if row else 'elemgather'}_{name}",
                  _row_step if row else _elem_step, idx, 8, (tbl,)),
                 (f"index_select_{name}",
                  _index_select_row_step if row else _index_select_elem_step, idx, 8, (tbl32,))]
        _timed(results, "take", specs, {s[0]: nbytes for s in specs},
               lambda _, sec: f"{n_idx / sec / 1e6:.0f} M {what}/s", reps)

    data = _dev(rng.integers(0, 2**32, n_data, dtype=np.uint32), device)
    for w in (8, 16, 32, 64, 128):
        ridx = rng.integers(0, n_data // w, n_idx, dtype=np.uint32).astype(np.int32)
        pair(f"w{w}_16MB", data.view(-1, w), _dev(ridx, device), n_idx * w * 4)
    for mb in (1, 2, 4, 8, 16, 32):
        nd = (mb << 18) // shrink
        tbl = _dev(rng.integers(0, 2**32, nd, dtype=np.uint32), device).view(-1, 128)
        ridx = rng.integers(0, nd // 128, n_idx, dtype=np.uint32).astype(np.int32)
        pair(f"{mb}MB_w128", tbl, _dev(ridx, device), n_idx * 128 * 4)
        del tbl
    tbl = data.view(-1, 128)
    ridx = rng.integers(0, n_data // 128, n_idx, dtype=np.uint32)
    for order, idx in (("rand", ridx), ("sorted", np.sort(ridx))):
        pair(f"{order}_16MB_w128", tbl, _dev(idx.astype(np.int32), device), n_idx * 128 * 4)
    eidx = rng.integers(0, n_data, n_idx, dtype=np.uint32)
    for order, idx in (("rand", eidx), ("sorted", np.sort(eidx))):
        pair(f"{order}_16MB", data, _dev(idx.astype(np.int32), device), n_idx * 4, "idx")
    return results["take"]


def run(sections=SECTIONS, device: str = "cuda", shrink: int = 1, reps: int = REPS) -> dict:
    """Run the named sections, every length divided by ``shrink``. Returns
    {section: {name: reading}}."""
    bad = [s for s in sections if s not in SECTIONS]
    if bad:
        raise ValueError(f"unknown section {bad[0]!r}; sections are {SECTIONS}")
    results: dict = {}
    for s in sections:
        globals()[f"measure_{s}"](results, device=device, shrink=shrink, reps=reps)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*", metavar="SECTION",
                    help=f"any of {' '.join(SECTIONS)} (default: all)")
    ap.add_argument("--out", help="also write the readings to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_r3 needs a CUDA device", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    results = run(args.sections or SECTIONS)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": card, **results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
