"""Runtime configuration (counterpart of ``dpu_olap_tpu/config.py``).

The same env tiers as the JAX package: NR_DEVICES (or NR_DPUS), SF and
MAX_THREADS, plus the feature flags the port reads (ENABLE_PERF, ENABLE_LOG,
ENABLE_TRACE, ACTIVATE_JOIN_TIMERS). The JAX package's
``shuffle_counts_inband`` (the multi-device exchange) arrives with the
multi-device work (ROADMAP §1, "Multi-device").
"""

from __future__ import annotations

import dataclasses
import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return int(v)


def nr_devices(default: int | None = None) -> int:
    """Number of devices to use (reference NR_DPUS). Defaults to the number
    of visible CUDA devices; there is no CPU fallback, so with no CUDA device
    this is 0."""
    if "NR_DEVICES" in os.environ:
        return _env_int("NR_DEVICES", 0)
    if "NR_DPUS" in os.environ:
        return _env_int("NR_DPUS", 0)
    if default is not None:
        return default
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def scale_factor() -> int:
    """SF workload scale factor (1 by default)."""
    return _env_int("SF", 1)


def max_threads() -> int:
    """Host CPU threads for host-side work (reference MAX_THREADS)."""
    return _env_int("MAX_THREADS", os.cpu_count() or 1)


@dataclasses.dataclass
class Flags:
    """Feature flags (reference shared/umq/cflags.h).

    enable_perf     -> device profiling in metrics.trace (ENABLE_PERF)
    enable_log      -> verbose operator logging (ENABLE_LOG)
    enable_trace    -> filter v1's per-tile progress print (ENABLE_TRACE,
                       reference trace(), shared/umq/log.h:13-17)
    join_timers     -> per-phase attribution of the shuffle join
                       (ACTIVATE_JOIN_TIMERS, the reference's compile flag,
                       host/join/join_dpu.cc:27-49): JoinGpu._run_ici times
                       chained prefixes afterwards (dist_join_phase_ms),
                       extra device work, so off by default
    shuffle_slack   -> padding factor for the ragged all-to-all partition
                       exchange (reference sizes partitions with 1.5-2x slack,
                       host/join/join_dpu.cc:97-100)

    The bucket mapping is always the radix top-bits one (the reference's
    USE_RADIX_PARTITIONING=1, cflags.h:28-30): no caller asks for modulo.
    """

    enable_perf: bool = True
    enable_log: bool = False
    enable_trace: bool = False
    shuffle_slack: float = 2.0
    # Round streaming (the reference's batch-round outer loop,
    # filter_dpu.cc:127-156): max rows resident per dispatched round.
    stream_round_rows: int = 64 << 20
    join_timers: bool = False


FLAGS = Flags(
    enable_perf=_env_int("ENABLE_PERF", 1) != 0,
    enable_log=_env_int("ENABLE_LOG", 0) != 0,
    enable_trace=_env_int("ENABLE_TRACE", 0) != 0,
    join_timers=_env_int("ACTIVATE_JOIN_TIMERS", 0) != 0,
)
