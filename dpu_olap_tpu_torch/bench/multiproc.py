"""The BM_JoinDpu shuffle join over a process group, one process a device
(the counterpart of the JAX package's join run under ``jax.distributed``).

    python -m dpu_olap_tpu_torch.bench.multiproc --nproc N [--backend nccl|gloo] [--sf 8]
        [--mesh HxC] [--rounds R] [--impl cosort|sort|cuckoo] [--device cuda|cpu]
    torchrun --nproc-per-node N -m dpu_olap_tpu_torch.bench.multiproc [same options]

It spawns N ranks (``parallel/process_group.spawn``: torch.multiprocessing,
spawn, a ``tcp://127.0.0.1`` rendezvous on a free port); under torchrun
(RANK and WORLD_SIZE set) this process is one rank and rank 0 prints. Each
rank builds BM_JoinDpu's tables, ``make_join_tables(SF, 2**21, 2**21)``
from seed 42, as every JAX process holds the same host tables, takes its
own rows (``GroupSet.split``) and runs the flat shuffle join
(``dist_join_retry``, JoinGpu's cell doubling decided from every rank's
flag) or, with ``--mesh HxC``, the two-stage join over a ProcessMesh2D
(``dist_join_2d``): the one-controller functions, over the group. Rank 0 gathers the matched rows and holds them to the
dense truth: every left row once, and x = right_x[fk - pk0].

The line: backend, world, sf, mesh, rounds, impl, ok, and for each rank
``join_total_ms`` (the join after a warm-up one, barrier to the rank's
device finishing), ``exchange_ms`` (the exchange phase of
``dist_join_phase_ms_group``: CUDA events after a barrier), the exchange's
bytes and collectives in the timed join, its partition, sort, fill, fill_match and
gather kernel launches, its matched rows, and a SHA-256 of its padded
outputs (fk, y, x, matched), which the one-controller join's shard of the
same rank must match. NCCL (the default on a card) takes one rank a card;
gloo puts ranks beyond the visible cards all on cuda:0. Without a card it
exits 1 unless given ``--device cpu``; a rank that fails fails the run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

SEED = 42
ROWS = 1 << 21  # a BM_JoinDpu batch, each side
KEYS31 = 0x7FFFFFFF  # keys below it take the packed-key co-sort (JoinGpu.Prepare)


def shard(out, t: int) -> tuple:
    """Shard t of a join's outputs (fk, left_cols, right_cols, matched,
    overflow), each a tuple of shards."""
    fk, lcols, rcols, matched, overflow = out
    return (fk[t], tuple(c[t] for c in lcols), tuple(c[t] for c in rcols), matched[t],
            overflow[t])


def digest(fk, lcols, rcols, matched) -> str:
    """SHA-256 of a join's padded outputs, in order, as host bytes."""
    h = hashlib.sha256()
    for t in (fk, *lcols, *rcols, matched):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _kernels() -> dict:
    from ..ops import fill_match_cuda, partition_cuda, scan_cuda, sort_cuda, take_cuda

    return {"partition": partition_cuda, "sort": sort_cuda, "fill": scan_cuda,
            "fill_match": fill_match_cuda, "gather": take_cuda}


def dense_truth(device, lc, rc, fk, y, x) -> bool:
    """Every left row once, and x = right_x[fk - pk0], on ``device``."""
    n_r = rc.num_rows
    pos = fk.astype(np.int64) - int(rc["pk"][0])
    if len(fk) != lc.num_rows or pos.min(initial=0) < 0 or pos.max(initial=0) >= n_r:
        return False
    if not np.array_equal(x, rc["x"][pos]):
        return False

    def rows(f, v):
        packed = torch.from_numpy((f.astype(np.int64) << 32) | v).to(device)
        return torch.sort(packed).values

    return torch.equal(rows(fk, y), rows(lc["fk"], lc["y"]))


def rank_join(gs, sf: int = 8, mesh=None, rounds: int = 1, impl: str = "cosort",
              rows: int = ROWS) -> dict:
    """One rank's BM_JoinDpu join over the group gs (a GroupSet), flat or,
    with mesh = (H, C), over a ProcessMesh2D of gs (made here: every rank of
    gs calls this alike). Returns the rank's readings and checks."""
    from ..config import FLAGS
    from ..generator import make_join_tables
    from ..metrics import counts
    from ..parallel.dist_join import dist_join_phase_ms_group, dist_join_retry
    from ..parallel.multihost import dist_join_2d, make_mesh_2d
    from ..parallel.shuffle import default_cell_size

    left, right = make_join_tables(sf, rows, rows, seed=SEED)
    lc, rc = left.concat(), right.concat()
    keys31 = bool(lc["fk"].max() < KEYS31 and rc["pk"].max() < KEYS31)
    lf, ly, rk, rx = (gs.split(a) for a in (lc["fk"], lc["y"], rc["pk"], rc["x"]))
    grid = make_mesh_2d(*mesh, group=gs) if mesh else None

    # the 2-D join's cells: the flat join's first (its retry returns its own)
    cell = default_cell_size(lf[0].shape[0], gs.world_size * rounds, FLAGS.shuffle_slack)

    def join():
        if grid is None:
            return dist_join_retry(gs, lf, (ly,), rk, (rx,), impl=impl, keys31=keys31,
                                   rounds=rounds)
        return dist_join_2d(grid, lf, (ly,), rk, (rx,), cell_left=cell, cell_right=cell,
                            rounds=rounds), (cell, cell)

    join()  # warm-up: the allocator's blocks, the collectives' first setup
    kernels = _kernels()
    before = {k: m.LAUNCHES for k, m in kernels.items()}
    counted = counts()
    gs.barrier()
    t = time.perf_counter()
    out, cells = join()
    gs.sync()
    total_ms = (time.perf_counter() - t) * 1e3
    launches = {k: m.LAUNCHES - before[k] for k, m in kernels.items()}
    nbytes, colls = (counts().get(k, 0) - counted.get(k, 0)
                     for k in ("exchange.bytes", "exchange.collectives"))
    fk, (y,), (x,), matched, overflow = shard(out, 0)
    over = gs.any(overflow)
    # the phases at the cells the join ran with
    if grid is None:
        phases = dist_join_phase_ms_group(gs, lf[0], rk[0], 1, 1, *cells, impl=impl,
                                          keys31=keys31, rounds=rounds)
    else:  # dist_join_2d's local join: the generic co-sort
        phases = dist_join_phase_ms_group(gs, lf[0], rk[0], 1, 1, *cells, rounds=rounds,
                                          mesh=grid)
    # uint32 moves as int32 bits: torch masks no uint32 on the card
    got = [gs.gather(c.view(torch.int32)[matched]) for c in (fk, y, x)]
    ok = gs.rank != 0 or (not over and dense_truth(gs.device, lc, rc,
                                                   *(g.view(np.uint32) for g in got)))
    ok = not gs.any(torch.tensor([not ok]))  # rank 0's verdict, for every rank
    return {"rank": gs.rank, "world": gs.world_size, "device": str(gs.device),
            "join_total_ms": total_ms, "exchange_ms": phases["exchange-ms"],
            "phase_ms": phases, "exchange_bytes": nbytes, "collectives": colls,
            "launches": launches, "matched": int(matched.sum()), "ok": ok,
            "digest": digest(fk, (y,), (x,), matched)}


def _parse_mesh(text: str | None):
    if text is None:
        return None
    h, _, c = text.partition("x")
    if not (h.isdigit() and c.isdigit()):
        raise argparse.ArgumentTypeError(f"--mesh takes HxC, got {text!r}")
    return int(h), int(c)


def main(argv=None) -> int:
    from ..parallel.process_group import init_group, spawn

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=1, help="ranks to spawn (not under torchrun)")
    ap.add_argument("--backend", choices=("nccl", "gloo"),
                    help="nccl on a card, gloo on the CPU (default)")
    ap.add_argument("--sf", type=int, default=8, help="BM_JoinDpu batches of 2Mi rows a side")
    ap.add_argument("--mesh", type=_parse_mesh, help="HxC: the two-stage join over H hosts"
                    " of C ranks")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--impl", choices=("cosort", "sort", "cuckoo"), default="cosort")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multiproc needs a CUDA device (--device cpu runs the ranks on the CPU)",
              file=sys.stderr)
        return 1
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    job = (args.sf, args.mesh, args.rounds, args.impl)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # one rank under torchrun
        import torch.distributed as dist

        with init_group(backend, device="cpu" if args.device == "cpu" else None) as gs:
            ranks = [None] * gs.world_size
            dist.gather_object(rank_join(gs, *job), ranks if gs.rank == 0 else None, dst=0)
            if gs.rank != 0:
                return 0
    else:
        device = "cpu" if args.device == "cpu" else None
        cards = torch.cuda.device_count() if args.device == "cuda" else 0
        if args.device == "cuda" and args.nproc > cards:
            if backend == "nccl":
                print(f"multiproc: NCCL takes one rank a card: {args.nproc} ranks, {cards}"
                      " card(s) (gloo runs several ranks on one card)", file=sys.stderr)
                return 1
            device = "cuda:0"
            print(f"multiproc: the {args.nproc} gloo ranks all run on cuda:0", file=sys.stderr)
        ranks = spawn(rank_join, args.nproc, args=job, backend=backend, device=device)
    line = {"backend": backend, "world": len(ranks), "sf": args.sf,
            "mesh": "x".join(map(str, args.mesh)) if args.mesh else None,
            "rounds": args.rounds, "impl": args.impl, "ok": all(r["ok"] for r in ranks),
            "ranks": ranks}
    if args.device == "cuda":
        line["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(line), flush=True)
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
