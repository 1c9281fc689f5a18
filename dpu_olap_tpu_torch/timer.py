"""Named per-rank phase timers (counterpart of ``dpu_olap_tpu/timer.py``).

Nanosecond start/stop per rank id, summed across ranks (reference
host/timer/timer.{h,cc}). ``Timers()`` returns the native C++ registry
(``native.NativeTimers``, the port's runtime.cpp), as the JAX package's does;
``_PyTimers`` is the plain version the tests hold it against.
"""

from __future__ import annotations

import time
from typing import Dict


class _PyTimers:
    def __init__(self):
        self._acc: Dict[str, Dict[int, int]] = {}
        self._open: Dict[tuple, int] = {}

    def start(self, name: str, rank: int = 0):
        self._open[(name, rank)] = time.monotonic_ns()

    def stop(self, name: str, rank: int = 0):
        t0 = self._open.pop((name, rank), None)
        if t0 is None:
            return
        self._acc.setdefault(name, {}).setdefault(rank, 0)
        self._acc[name][rank] += time.monotonic_ns() - t0

    def sum_ns(self, name: str) -> int:
        return sum(self._acc.get(name, {}).values())

    def sum_ms(self, name: str) -> float:
        return self.sum_ns(name) / 1e6

    def rank_count(self, name: str) -> int:
        return len(self._acc.get(name, {}))


def Timers():
    """Create a timer registry (the native one; raises if the runtime does
    not build)."""
    from . import native

    return native.NativeTimers()


class timed:
    """Context manager: with timed(timers, "phase", rank): ..."""

    def __init__(self, timers, name: str, rank: int = 0):
        self.t, self.name, self.rank = timers, name, rank

    def __enter__(self):
        if self.t is not None:
            self.t.start(self.name, self.rank)
        return self

    def __exit__(self, *exc):
        if self.t is not None:
            self.t.stop(self.name, self.rank)
        return False
