"""The port's stream_rounds and round_geometry
(dpu_olap_tpu_torch.parallel.streaming) against the JAX package's: ordering,
the in-flight bound, overlap of collect with dispatch, errors, timers."""

import threading
import time

import pytest

from dpu_olap_tpu.parallel.streaming import round_geometry as jax_round_geometry
from dpu_olap_tpu_torch.parallel.streaming import round_geometry, stream_rounds
from dpu_olap_tpu_torch.timer import Timers


def test_results_ordered_with_slow_collect():
    def collect(r, h):
        if r == 0:
            time.sleep(0.05)
        return h + 1

    out = stream_rounds(8, lambda r: r, lambda r, s: s * 10, collect)
    assert out == [r * 10 + 1 for r in range(8)]


def test_inflight_bound_respected():
    live = peak = 0
    lock = threading.Lock()

    def dispatch(r, staged):
        nonlocal live, peak
        with lock:
            live += 1
            peak = max(peak, live)
        return staged

    def collect(r, h):
        nonlocal live
        time.sleep(0.01)
        with lock:
            live -= 1
        return h

    out = stream_rounds(10, lambda r: r, dispatch, collect, max_inflight=2)
    assert out == list(range(10))
    # the drain runs before each dispatch, so the new round is within bound
    assert peak <= 2, peak


def test_collect_overlaps_dispatch():
    # 4 rounds of 30 ms dispatch + 30 ms collect: 240 ms serial, about
    # 150 ms when each collect hides under the next dispatch
    def slow(r, x):
        time.sleep(0.03)
        return x

    t0 = time.perf_counter()
    out = stream_rounds(4, lambda r: r, slow, slow, max_inflight=2)
    assert out == list(range(4))
    assert time.perf_counter() - t0 < 0.21


def test_collect_error_propagates():
    def collect(r, h):
        if r == 2:
            raise ValueError("boom")
        return h

    with pytest.raises(ValueError, match="boom"):
        stream_rounds(5, lambda r: r, lambda r, s: s, collect)


def test_timers_populated():
    t = Timers()
    stream_rounds(3, lambda r: r, lambda r, s: s, lambda r, h: h, timers=t)
    for phase in ("stage", "dispatch", "collect"):
        assert t.rank_count(phase) == 3, phase


@pytest.mark.parametrize(
    "n_batches, n_devices, rows, round_rows",
    [(16, 4, 1 << 10, 1 << 13), (1024, 1, 1 << 16, 64 << 20), (12, 1, 1 << 20, 5 << 20),
     (8, 1, 1 << 22, 64 << 20), (7, 1, 100, 250), (3, 1, 1 << 30, 1 << 20)],
)
def test_round_geometry_matches_jax(n_batches, n_devices, rows, round_rows):
    got = round_geometry(n_batches, n_devices, rows, round_rows=round_rows)
    assert got == jax_round_geometry(n_batches, n_devices, rows, round_rows=round_rows)
    rpr, rounds = got
    assert rpr * rounds * n_devices == n_batches
    assert rpr == 1 or rpr * n_devices * rows <= round_rows


def test_round_geometry_rejects_uneven_devices():
    with pytest.raises(ValueError, match="do not divide"):
        round_geometry(7, 2, 10)
