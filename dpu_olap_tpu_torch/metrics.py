"""Operator logging (counterpart of ``dpu_olap_tpu/metrics.py``: the
``log`` and ``device_log`` the join operator uses)."""

from __future__ import annotations

import sys

import numpy as np

from .config import FLAGS


def log(msg: str) -> None:
    """Operator-level logging (reference log(), shared/umq/log.h:6-11)."""
    if FLAGS.enable_log:
        print(f"[dpu_olap_tpu_torch] {msg}", file=sys.stderr, flush=True)


def device_log(tag: str, per_device_values, names=None) -> None:
    """One log line per device for small per-device diagnostic arrays of
    shape (n_devices, ...), gated on ENABLE_LOG (DpuSet::log analog)."""
    if not FLAGS.enable_log:
        return
    vals = np.asarray(per_device_values)
    if vals.ndim == 1:
        vals = vals[:, None]
    vals = vals.reshape(vals.shape[0], -1)
    for dev in range(vals.shape[0]):
        row = vals[dev]
        if names:
            body = " ".join(f"{n}={v}" for n, v in zip(names, row))
        else:
            body = " ".join(str(v) for v in row)
        print(f"[dev {dev}] {tag}: {body}", file=sys.stderr, flush=True)
