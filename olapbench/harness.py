"""One run of one cell: set-up, warm-up, the measured window, the check.

A cell's traffic mix names its query (``queries/<query>.py``); the query
module makes the tables from the seed and gives the program's call. Each
process (one a chip) runs ``run_process``: set-up, the mix's warm-up
queries, then a closed loop with one client for the window's seconds (the
next query goes out when the last one's result is on the host), then,
once the window has closed and the peak memory has been read, the check
against the plain reference. On four chips each rank of a
``torch.distributed`` group (the program's ``process_group.spawn``, NCCL
on the cards) does so, and rank 0 decides, in the query's own collective,
when the window ends.

The query module gives:
  setup(env) -> state                  tables made on the device from the seed
  query(state, due) -> (answer, stop)  one query; ``due``: the window is over
  control_query(state, due)            the control: the plain reference in the
                                       program's place, a width lower
  check(state, answers, control) -> {name: (value, limit)}
                                       after the window: each number the
                                       query compares against the plain
                                       reference, this rank's share (the
                                       harness adds the ranks' values up)
  least_bytes(env), probe_rows(env)    the roofline's bytes a chip, the rate's
                                       rows a query
The harness itself adds ``failed_queries``, the queries that raised; these
and the check's ``answers_wrong`` (window answers unlike the reference's)
are the line's ``failed``.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Callable, Optional

import torch

from . import spec, trace as tracing

BANNED = ("jax", "jaxlib", "flax", "dpu_olap_tpu")  # top-level module names, compared whole


@dataclasses.dataclass
class Ctx:
    """What every process of a run is told (pickled to spawned ranks)."""

    seed: int
    seconds: float
    trace: bool
    chips: int
    config: dict
    traffic: dict
    device: str = "cuda:0"  # "cpu" only for tests and rehearsals, called as a function
    control: bool = False  # the reference in the program's place
    hook: Optional[Callable] = None  # called first in each process (tests break the program)
    started: float = 0.0  # time.time() at the process's start
    marks: dict = dataclasses.field(default_factory=dict)  # set-up s so far, by step


@dataclasses.dataclass
class Env:
    """One process's view: its device, rank and group."""

    ctx: Ctx
    device: torch.device
    rank: int = 0
    world: int = 1
    gs: object = None  # the program's GroupSet on four chips

    @property
    def config(self) -> dict:
        return self.ctx.config

    @property
    def seed(self) -> int:
        return self.ctx.seed


def banned_modules() -> list:
    """The JAX side's modules this process has loaded, by top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(query, state, seconds: float, device, trace_queries: int = 0):
    """Run queries back to back until one that went out after ``seconds``
    has returned; the first ``trace_queries`` of them under the profiler.
    Returns (latencies s, answers, window s, error text or None, profiler)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    lat, answers, error, prof, span = [], [], None, None, None
    if trace_queries:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function(tracing.SLICE)
        span.__enter__()
    start = time.perf_counter()
    try:
        while True:
            t0 = time.perf_counter()
            with record_function(tracing.QUERY):
                value, stop = query(state, t0 - start >= seconds)
            lat.append(time.perf_counter() - t0)
            answers.append(value)
            if span is not None and len(lat) == trace_queries:
                _sync(device)
                span.__exit__(None, None, None)
                span = None
                prof.__exit__(None, None, None)
            if stop:
                break
    except Exception as exc:  # a query that raises fails the run; the check says so
        import traceback

        error = f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"
    window = time.perf_counter() - start
    if span is not None:
        _sync(device)
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    return lat, answers, window, error, prof


def run_process(ctx: Ctx, gs=None) -> dict:
    """Set-up, warm-up, window and check in this process (a rank of gs on
    four chips)."""
    if ctx.hook is not None:
        ctx.hook()
    if gs is not None:
        env = Env(ctx, gs.device, gs.rank, gs.world_size, gs)
    else:
        env = Env(ctx, torch.device(ctx.device))
        if env.device.type == "cuda":
            torch.cuda.set_device(env.device)
    marks = dict(ctx.marks)
    if env.device.type == "cuda":
        torch.zeros(1, device=env.device)  # the context, on its own mark
        _sync(env.device)
    marks["context_made"] = time.time() - ctx.started
    if ctx.traffic["loop"] != "closed" or ctx.traffic["clients"] != 1:
        raise ValueError("the harness runs a closed loop with one client")
    q = spec.query_module(ctx.traffic["query"])
    run_query = q.control_query if ctx.control else q.query
    state = q.setup(env)
    _sync(env.device)
    marks["tables_made"] = time.time() - ctx.started
    for _ in range(int(ctx.traffic["warmup_queries"])):
        run_query(state, False)
    _sync(env.device)
    marks["warmed_up"] = time.time() - ctx.started
    if env.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(env.device)
    window_started = time.time()
    n_trace = int(ctx.traffic["trace_queries"]) if ctx.trace else 0
    lat, answers, window, error, prof = closed_loop(run_query, state, ctx.seconds, env.device,
                                                 n_trace)
    peak = torch.cuda.max_memory_allocated(env.device) if env.device.type == "cuda" else 0
    out = {"rank": env.rank, "window_started": window_started,
           "window_s": window, "latencies_s": lat, "peak_bytes": peak, "error": error,
           "banned": banned_modules(), "setup_marks": marks}
    if env.device.type == "cuda":
        out["device_kind"] = torch.cuda.get_device_name(env.device)
    if prof is not None:
        out["trace"] = tracing.summarize(prof.events(), env.rank, q.least_bytes(env),
                                         tracing.port_kernels())
        del prof
    if error is None:
        out["checks"] = q.check(state, answers, ctx.control)
    return out


def _rank_main(gs, ctx: Ctx) -> dict:
    return run_process(ctx, gs)


def execute(ctx: Ctx) -> list:
    """Run ctx on its chips: one result a rank."""
    if ctx.chips == 1:
        return [run_process(ctx)]
    from dpu_olap_tpu_torch.parallel.process_group import spawn

    on_cpu = ctx.device == "cpu"
    return spawn(_rank_main, ctx.chips, args=(ctx,), backend="gloo" if on_cpu else "nccl",
                 device="cpu" if on_cpu else None)


# ---- the result line ---------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What the metric readers read: every rank's result."""

    ranks: list
    setup_s: float
    probe_rows: int  # rows a query, every chip's together

    @property
    def lead(self) -> dict:
        return self.ranks[0]

    @property
    def traces(self) -> list:
        return [r["trace"] for r in self.ranks if "trace" in r]


def checks(ranks: list) -> dict:
    """Each number compared, with its limit (the last key of the line): the
    queries that raised, and the query's own numbers added up over the
    ranks. A rank whose window broke off runs no check; its query that
    raised fails the run."""
    total = {"failed_queries": [sum(1 for r in ranks if r["error"]), 0]}
    for r in ranks:
        for name, (value, limit) in r.get("checks", {}).items():
            total.setdefault(name, [0, limit])[0] += value
    return {k: {"value": v, "limit": lim} for k, (v, lim) in total.items()}


def result_line(cell: spec.Cell, ctx: Ctx, ranks: list) -> dict:
    """The run's JSON object."""
    q = spec.query_module(ctx.traffic["query"])
    lead = ranks[0]
    run = Run(ranks, lead["window_started"] - ctx.started,
              q.probe_rows(Env(ctx, torch.device("cpu"), 0, ctx.chips)))
    wanted = cell.per_layer if ctx.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = checks(ranks)
    attempted = len(lead["latencies_s"]) + (1 if lead["error"] else 0)
    failed = compared["failed_queries"]["value"] + compared.get("answers_wrong", {"value": 0})["value"]
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    device = {"platform": "cpu" if ctx.device == "cpu" else "gpu",
              "kind": lead.get("device_kind", ctx.device), "count": ctx.chips,
              "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device}
    if ctx.trace and run.traces:
        tr = run.traces
        device["busy_s"] = sum(t.busy_us for t in tr) / len(tr) / 1e6
        device["window_s"] = sum(t.span_us for t in tr) / len(tr) / 1e6
        line["breakdown"] = tracing.breakdown(tr[0])
    line["checks"] = compared
    return line


def p95(values) -> float:
    """The 95th percentile by nearest rank: a value that was observed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
