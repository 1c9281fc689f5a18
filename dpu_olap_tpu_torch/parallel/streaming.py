"""Bounded round-streaming pipeline (counterpart of
``dpu_olap_tpu/parallel/streaming.py``).

Reference: the batch-round loops of host/filter/filter_dpu.cc:127-156 and
host/take/take_dpu.cc:62-91 — when #batches > NR_DPUS, rounds of batches
stream through fixed device buffers, with per-rank async callback chains
overlapping copy-in / exec / copy-out (dpuext.hpp:859-899).

Here:
  * host staging (the operators' native.parallel_stack of the round's
    batches) runs on a background thread one round ahead of the device;
  * device dispatch is asynchronous (a CUDA launch returns before the card
    finishes), so successive rounds queue back-to-back on the stream;
  * results are collected in order on one worker thread, and at most
    ``max_inflight`` dispatched rounds (2 by default; the reference bounds
    its per-rank job queues) may be outstanding before the dispatcher
    blocks. A collect ends in a host copy (``.cpu()``), which waits for its
    round's device work, so the bound holds device memory to
    ``max_inflight`` rounds of buffers.

The collect worker is a thread of its own: CUDA work it queues must name its
device explicitly (``torch.cuda.device(...)``), because the current device is
per thread.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List

from ..config import FLAGS
from ..timer import timed


def stream_rounds(
    n_rounds: int,
    stage: Callable[[int], object],
    dispatch: Callable[[int, object], object],
    collect: Callable[[int, object], object],
    max_inflight: int = 2,
    timers=None,
) -> List[object]:
    """Run ``n_rounds`` of stage -> dispatch -> collect with staging
    prefetched one round ahead and at most max_inflight dispatched rounds
    outstanding. Returns [collect(r, ...) for r in rounds] in order.

    stage(r)            host-side preparation (background thread)
    dispatch(r, staged) enqueue device work, return a handle (main thread)
    collect(r, handle)  materialize the round's result on the host (worker
                        thread; blocks on the device)
    """
    def timed_stage(r):
        with timed(timers, "stage", r):
            return stage(r)

    def timed_collect(r, h):
        with timed(timers, "collect", r):
            return collect(r, h)

    futs: List[object] = []
    inflight: List[object] = []
    with ThreadPoolExecutor(max_workers=1) as pool, ThreadPoolExecutor(
        max_workers=1
    ) as cpool:
        nxt = pool.submit(timed_stage, 0)
        for r in range(n_rounds):
            staged = nxt.result()
            if r + 1 < n_rounds:
                nxt = pool.submit(timed_stage, r + 1)
            # drain before dispatching so the bound counts the new round
            while len(inflight) >= max_inflight:
                inflight.pop(0).result()
            with timed(timers, "dispatch", r):
                h = dispatch(r, staged)
            f = cpool.submit(timed_collect, r, h)
            futs.append(f)
            inflight.append(f)
        return [f.result() for f in futs]


def round_geometry(
    n_batches: int, n_devices: int, rows_per_batch: int,
    round_rows: int | None = None,
) -> tuple[int, int]:
    """Choose (batches_per_device_per_round, n_rounds) such that one round
    holds at most ``round_rows`` rows device-resident (FLAGS.stream_round_rows
    by default), the analog of the reference's fixed MRAM buffers (8Mi
    items, dpu/filter/main.c:20). Rounds divide the batches evenly.

    n_batches must be a multiple of n_devices (the reference asserts
    batches % nr_dpus == 0, filter_dpu.cc:127).
    """
    if round_rows is None:
        round_rows = FLAGS.stream_round_rows
    if n_devices < 1 or n_batches % n_devices:
        raise ValueError(f"{n_batches} batches do not divide over {n_devices} devices")
    per_dev = n_batches // n_devices
    max_rpr = max(1, round_rows // (n_devices * max(1, rows_per_batch)))
    rpr = min(per_dev, max_rpr)
    while per_dev % rpr:
        rpr -= 1
    return rpr, per_dev // rpr
