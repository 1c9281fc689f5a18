"""The several-device dry run and the weak-scaling benchmark of the shuffle
join (counterpart of ``__graft_entry__.py:dryrun_multichip`` and
``scripts/bench_multichip.py``).

    python -m dpu_olap_tpu_torch.bench.multichip --dryrun 4
    python -m dpu_olap_tpu_torch.bench.multichip [--devices N] [--rows-per-dev R] [--curve]
        [--device cpu] [--out FILE]

``dryrun_multichip(n)`` runs one step of every path over n devices: the
flat shuffle join, the hierarchical 2 x n/2 join in one round and in two,
the skewed-key join through JoinGpu's cell-doubling retry, the host-staged
and resident multi-round joins and the resident repartition, each checked
against the same truths as the JAX dry run, with its "... ok" line.

The benchmark prints one JSON line under bench_multichip.py's keys: the
one-device join's rows/s, the d-device join's (``multi_rows_per_s``,
``weak_scaling_efficiency``) and, with ``--curve``, the weak-scaling curve
over d = 1, 2, 4 ... (rows_per_dev rows a device), the same curve without
the exchange (``local_curve_no_collectives``) and each d's phase
attribution with the counts in the cells and apart. The JAX script's
``all_to_all_ops_in_program`` counts XLA collectives in the compiled
program; the port has no compiled program, and gives what its exchange
moved instead (``exchange_copies``, ``exchange_bytes``).

Shards are placed in turn over the visible CUDA devices, repeating them
when there are fewer than n; the line says how many are physical. Shards
that share a card run one after another on it, so such a curve measures the
overhead of the split and the exchange, not a speed-up. Without a CUDA
device it raises; ``device="cpu"`` (``--device cpu``) places every shard on
the CPU, the tests' path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..parallel.mesh import DeviceSet

SEED = 42


def device_set(n: int, device: str | None = None) -> DeviceSet:
    """n shards: on the CPU for device="cpu", else in turn over the visible
    CUDA devices (raises when there is none)."""
    if device == "cpu":
        return DeviceSet([torch.device("cpu")] * n)
    if device is not None:
        raise ValueError(f"device is None (the CUDA devices) or 'cpu', got {device!r}")
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device (device='cpu' runs on the CPU)")
    cards = torch.cuda.device_count()
    return DeviceSet([torch.device("cuda", i % cards) for i in range(n)])


def dryrun_multichip(n_devices: int, device: str | None = None) -> None:
    from ..columnar import Batch, Table
    from ..operators.join_op import JoinGpu
    from ..operators.partition_op import PartitionGpu
    from ..parallel.dist_join import dist_join_spmd
    from ..parallel.multihost import dist_join_2d, make_mesh_2d
    from ..parallel.shuffle import default_cell_size

    ds = device_set(n_devices, device)
    print(f"dryrun_multichip({n_devices}): {n_devices} shards on {len(ds.physical)} physical"
          f" {'device' if len(ds.physical) == 1 else 'devices'} ({ds.device.type})", flush=True)

    # 64Ki rows a device: every kernel runs on several tiles, small enough
    # for a CPU run
    n_local = 1 << 16
    # slack-padded cells: at small device counts the worst hash fragment
    # exceeds the zero-slack average
    cell = default_cell_size(n_local, n_devices, 2.0)
    n_left = n_right = n_devices * n_local
    rng = np.random.default_rng(SEED)
    right_pk = rng.permutation(n_right).astype(np.uint32)
    right_x = rng.integers(0, 2**32, n_right, dtype=np.uint32)
    left_fk = rng.integers(0, n_right, n_left).astype(np.uint32)
    left_y = rng.integers(0, 2**32, n_left, dtype=np.uint32)
    order = np.argsort(right_pk)

    def check_x(fk, x, what):
        want = right_x[order[np.searchsorted(right_pk[order], fk)]]
        if not np.array_equal(x, want):
            raise AssertionError(f"{what}: x != right_x at the matched pk")

    # keys < 2^31 - 1 by construction: the packed-key path
    fk, (y,), (x,), matched, overflow = dist_join_spmd(
        ds.split(left_fk), (ds.split(left_y),), ds.split(right_pk), (ds.split(right_x),),
        n_devices, cell, cell, keys31=True)
    ds.sync()
    if DeviceSet.gather(overflow).any():
        raise AssertionError("shuffle cell overflow")
    m = DeviceSet.gather(matched)
    if m.sum() != n_left:
        raise AssertionError(f"expected all {n_left} left rows matched, got {m.sum()}")
    check_x(DeviceSet.gather(fk)[m], DeviceSet.gather(x)[m], "flat mesh")
    print(f"dryrun_multichip({n_devices}): flat mesh ok, {int(m.sum())} rows joined", flush=True)

    # the hierarchical (hosts x chips) pipeline where the count splits in two
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh_2d(n_hosts=2, chips_per_host=n_devices // 2, ds=ds)
        for rounds in (1, 2):
            fk2, _, (x2,), m2, ov2 = dist_join_2d(mesh, left_fk, (left_y,), right_pk,
                                                  (right_x,), rounds=rounds)
            if DeviceSet.gather(ov2).any():
                raise AssertionError("2d shuffle cell overflow")
            m2 = DeviceSet.gather(m2)
            if m2.sum() != n_left:
                raise AssertionError(f"2d join rounds={rounds}: {m2.sum()} rows")
            check_x(DeviceSet.gather(fk2)[m2], DeviceSet.gather(x2)[m2], f"2d join rounds={rounds}")
            if rounds == 1:
                print(f"dryrun_multichip({n_devices}): hierarchical 2x{n_devices // 2} mesh ok",
                      flush=True)
            else:
                print(f"dryrun_multichip({n_devices}): hierarchical multi-round ok (rounds=2)",
                      flush=True)

    # skewed keys: about 40% of fks on one hot key, so that key's device
    # receives far more than the average fragment; JoinGpu._run_ici doubles
    # its cells and retries (the reference throws, partition.cc:19-26)
    n_skew = n_devices * (1 << 12)
    hot = rng.integers(0, n_skew, 1)[0]
    skew_fk = np.where(rng.random(n_skew) < 0.4, np.uint32(hot),
                       rng.integers(0, n_skew, n_skew).astype(np.uint32))
    per = n_skew // n_devices
    skew_x = np.resize(right_x, per)
    skew_left = Table([Batch.from_numpy({"fk": skew_fk[i::n_devices], "y": left_y[:per]})
                       for i in range(n_devices)])
    skew_right = Table([Batch.from_numpy({"pk": np.arange(n_skew, dtype=np.uint32)[i::n_devices],
                                          "x": skew_x}) for i in range(n_devices)])
    out = JoinGpu(ds, skew_left, skew_right).Prepare().Run()
    if len(out["fk"]) != n_skew:
        raise AssertionError(f"skew join: {len(out['fk'])}/{n_skew} rows")
    # pk i sits in batch i % n at row i // n
    if not np.array_equal(out["x"], skew_x[out["fk"].astype(np.int64) // n_devices]):
        raise AssertionError("skew join: x != the x of its pk")
    print(f"dryrun_multichip({n_devices}): skewed-key join ok (hot-key retry path)", flush=True)

    # the host-staged multi-round path (virtual-DPU rounds through the
    # Partitioner and the native slabs, join_dpu.cc:191,254): more batches
    # than devices
    nb, per = 2 * n_devices, 1 << 12
    pk_all = rng.permutation(nb * per).astype(np.uint32)
    x_all = rng.integers(0, 2**32, nb * per, dtype=np.uint32)
    mr_left = Table([Batch.from_numpy({
        "fk": rng.integers(0, nb * per, per).astype(np.uint32),
        "y": rng.integers(0, 2**32, per, dtype=np.uint32)}) for _ in range(nb)])
    mr_right = Table([Batch.from_numpy({"pk": pk_all[i * per:(i + 1) * per],
                                        "x": x_all[i * per:(i + 1) * per]})
                      for i in range(nb)])
    x_of = np.empty(nb * per, np.uint32)
    x_of[pk_all] = x_all
    op = JoinGpu(ds, mr_left, mr_right).Prepare()
    for label, run in (("host-staged multi-round path ok", op._run_partitioned),
                       ("device-resident multi-round join ok", lambda: op._run_ici(rounds=2))):
        out = run()
        if len(out["fk"]) != nb * per or not np.array_equal(out["x"], x_of[out["fk"]]):
            raise AssertionError(f"{label}: {len(out['fk'])} rows or x wrong")
        detail = (f"({nb} batches over {n_devices} devices)" if "host" in label
                  else "(rounds=2, no host staging)")
        print(f"dryrun_multichip({n_devices}): {label} {detail}", flush=True)

    # the resident standalone repartition: partitions stay on the devices,
    # only the counts leave them here
    parts = PartitionGpu(ds, mr_left, "fk", nb).Prepare().Run()
    if not hasattr(parts, "to_host"):
        raise AssertionError("expected the resident engine")
    if int(parts.partition_rows().sum()) != nb * per:
        raise AssertionError("resident repartition lost rows")
    print(f"dryrun_multichip({n_devices}): resident repartition ok ({nb} partitions on the"
          f" devices)", flush=True)


# ---- weak scaling ------------------------------------------------------------


def _timed(fn, ds: DeviceSet, reps: int = 3) -> float:
    """Seconds a call of fn, the median of reps on the host clock after one
    warm-up, every device synchronised around each call."""
    fn()
    secs = []
    for _ in range(reps):
        ds.sync()
        t = time.perf_counter()
        fn()
        ds.sync()
        secs.append(time.perf_counter() - t)
    return float(np.median(secs))


def _columns(rows: int):
    from ..generator import make_join_tables

    left, right = make_join_tables(1, rows, rows, seed=SEED)
    lb, rb = left[0], right[0]
    return tuple(np.asarray(c) for c in (lb["fk"], lb["y"], rb["pk"], rb["x"]))


def run_single(rows_per_dev: int, ds: DeviceSet) -> float:
    """Rows/s of the fused join of rows_per_dev rows a side on ds's first
    device, no shuffle."""
    from ..ops.join import join_shard_fused

    lf, ly, rk, rx = (ds.scatter(a) for a in _columns(rows_per_dev))
    return rows_per_dev / _timed(lambda: join_shard_fused(lf, (ly,), rk, (rx,)),
                                 DeviceSet(ds.device))


def _placed(d: int, rows_per_dev: int, devices: DeviceSet):
    """The first d shards of devices as a DeviceSet, and the join's four
    columns of rows_per_dev * d rows placed on it: a tensor each on one
    device, a tuple of shards each over several."""
    ds = DeviceSet(devices.devices[:d])
    place = ds.scatter if d == 1 else ds.split
    return ds, tuple(place(a) for a in _columns(rows_per_dev * d))


def run_at(d: int, rows_per_dev: int, devices: DeviceSet) -> float:
    """A weak-scaling point: the shuffle join over the first d shards of
    devices, rows_per_dev rows a shard and side, inputs already placed."""
    from ..parallel.dist_join import dist_join

    ds, (lf, ly, rk, rx) = _placed(d, rows_per_dev, devices)
    return rows_per_dev * d / _timed(lambda: dist_join(ds, lf, (ly,), rk, (rx,)), ds)


def run_local_at(d: int, rows_per_dev: int, devices: DeviceSet) -> float:
    """The control point: each shard's fused join without the shuffle (no
    exchange at all), over the first d shards of devices."""
    from ..ops.join import join_shard_fused

    ds = DeviceSet(devices.devices[:d])
    shards = list(zip(*(ds.split(a) for a in _columns(rows_per_dev * d))))

    def run():
        for lf, ly, rk, rx in shards:
            join_shard_fused(lf, (ly,), rk, (rx,))

    return rows_per_dev * d / _timed(run, ds)


def exchange_traffic(d: int, rows_per_dev: int, devices: DeviceSet) -> dict:
    """What one shuffle join over d shards moves through the exchange."""
    from ..metrics import counts
    from ..parallel.dist_join import dist_join

    ds, (lf, ly, rk, rx) = _placed(d, rows_per_dev, devices)
    before = counts()
    dist_join(ds, lf, (ly,), rk, (rx,))
    ds.sync()
    after = counts()
    return {f"exchange_{k}": after.get(f"exchange.{k}", 0) - before.get(f"exchange.{k}", 0)
            for k in ("copies", "bytes")}


def _curve(points: list) -> list:
    base = points[0]["rows_per_s_per_device"]
    for row in points:
        row["weak_scaling_efficiency"] = row["rows_per_s_per_device"] / base
    return points


def bench(n_dev: int, rows_per_dev: int, curve: bool, device: str | None = None) -> dict:
    from ..config import FLAGS
    from ..parallel.dist_join import dist_join_phase_ms
    from ..parallel.shuffle import default_cell_size

    devices = device_set(n_dev, device)
    single = run_single(rows_per_dev, devices)
    result = {
        "devices": n_dev,
        "physical_devices": len(devices.physical),
        "rows_per_device": rows_per_dev,
        "single_rows_per_s": single,
        "host_cores": os.cpu_count(),
        "platform": devices.device.type,
    }
    if devices.device.type == "cuda":
        result["device_name"] = torch.cuda.get_device_name(devices.device)
    if n_dev > 1:
        multi = run_at(n_dev, rows_per_dev, devices)
        result["multi_rows_per_s"] = multi
        result["weak_scaling_efficiency"] = multi / (single * n_dev)
    if not curve:
        return result
    sizes = [d for d in (1 << i for i in range(n_dev.bit_length())) if d <= n_dev]
    points, local = [], []
    for d in sizes:
        r = run_at(d, rows_per_dev, devices)
        points.append({"devices": d, "rows_per_s": r, "rows_per_s_per_device": r / d})
        print(f"# D={d}: {r / 1e6:.2f} Mrows/s", file=sys.stderr, flush=True)
    for d in sizes:
        r = run_local_at(d, rows_per_dev, devices)
        local.append({"devices": d, "rows_per_s": r, "rows_per_s_per_device": r / d})
        print(f"# local D={d}: {r / 1e6:.2f} Mrows/s", file=sys.stderr, flush=True)
    result["curve"] = _curve(points)
    result["local_curve_no_collectives"] = _curve(local)
    result.update(exchange_traffic(n_dev, rows_per_dev, devices))
    attrib = {}
    for d in sorted({min(4, n_dev), n_dev}):
        ds = DeviceSet(devices.devices[:d])
        lf, _, rk, _ = _columns(rows_per_dev * d)
        cell = default_cell_size(rows_per_dev, d, FLAGS.shuffle_slack)
        phases = dist_join_phase_ms(ds, lf, rk, 1, 1, cell_left=cell, cell_right=cell, k=2)
        FLAGS.shuffle_counts_inband = True
        try:
            r_inband = run_at(d, rows_per_dev, devices)
        finally:
            FLAGS.shuffle_counts_inband = False
        r_two = run_at(d, rows_per_dev, devices)
        attrib[f"d{d}"] = {
            "phase_ms": {k: round(v, 3) for k, v in phases.items()},
            "rows_per_s_two_collectives": r_two,
            "rows_per_s_counts_inband": r_inband,
            "inband_speedup": r_inband / r_two,
        }
        print(f"# attrib D={d}: {attrib[f'd{d}']}", file=sys.stderr, flush=True)
    result["attribution"] = attrib
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", type=int, metavar="N", help="run dryrun_multichip(N) and exit")
    ap.add_argument("--devices", type=int, help="shards (default: the visible CUDA devices)")
    ap.add_argument("--rows-per-dev", type=int, default=1 << 20)
    ap.add_argument("--curve", action="store_true", help="the weak-scaling curve and attribution")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else "cpu"
    if device is None and not torch.cuda.is_available():
        print("multichip needs a CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 1
    if args.dryrun:
        dryrun_multichip(args.dryrun, device)
        return 0
    n = args.devices or (torch.cuda.device_count() if device is None else 1)
    result = bench(n, args.rows_per_dev, args.curve, device)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
