"""Merge-probe of a sorted probe column against a sorted build column
(counterpart of ``dpu_olap_tpu/ops/merge_pallas.py:merge_probe_pallas``).

``merge_probe`` launches ``csrc/merge_probe.cu`` for CUDA tensors and runs
the plain version ``merge_probe_ref`` for CPU tensors; any other device
raises. Contract (merge_pallas.py:249-319): for each element x of the
sorted uint32 probe column, the last position j of the sorted build column
with build[j] <= x — the greatest build key <= x, build keys being unique
apart from an EMPTY tail. Returns (has bool, pkey uint32, payloads uint32),
each of the probe's length: pkey is EMPTY (0xFFFFFFFF) and every payload 0
where there is no such key (merge_pallas.py:243-246).

The TPU wrapper pads the build side with (EMPTY, 0) rows to a multiple of
its block; the port reads the build column as it is. The two differ only
for a probe key equal to EMPTY when the build side is not a multiple of
that block (the TPU kernel finds its pad there, the port the last build
row): EMPTY keys are outside the TPU kernel's contract, and the sorted
hash table (hashtable.py) never reports them as found. Any probe length
is taken, and any build side below 2^32 keys (the kernel's positions are
32-bit), an empty one included.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels
from .hashtable import _signed_view

MAX_PAYLOADS = 8  # payload planes the kernel takes (csrc/merge_probe.cu MAX_PAYLOADS)
LAUNCHES = 0  # kernel launches by merge_probe (the CPU path adds none)


def _check(left, right, payloads) -> torch.device:
    for name, t in (("probe", left), ("build", right)):
        if t.dtype != torch.uint32 or t.dim() != 1:
            raise ValueError(f"merge_probe {name} keys must be a 1-D uint32 tensor")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"merge_probe takes at most {MAX_PAYLOADS} payload planes, got {len(payloads)}")
    for p in payloads:
        if p.dtype != torch.uint32 or p.shape != right.shape:
            raise ValueError("merge_probe payloads must be 1-D uint32 of the build keys' length")
    if right.shape[0] > 0xFFFFFFFF:
        raise ValueError("merge_probe takes fewer than 2^32 build keys (32-bit positions)")
    dev = left.device
    if any(t.device != dev for t in (right, *payloads)):
        raise ValueError("merge_probe planes must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_probe runs on cuda or cpu tensors, got {dev}")
    return dev


def _empty_build(left, payloads):
    n = left.shape[0]
    dev = left.device
    return (
        torch.zeros(n, dtype=torch.bool, device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev).view(torch.uint32),
        tuple(torch.zeros(n, dtype=torch.uint32, device=dev) for _ in payloads),
    )


def merge_probe_ref(left_sorted, right_sorted, right_payloads=()):
    """Plain PyTorch version: an upper-bound ``torch.searchsorted`` over the
    build keys' order-preserving int32 view, then one gather per plane."""
    right_payloads = tuple(right_payloads)
    if right_sorted.shape[0] == 0:
        return _empty_build(left_sorted, right_payloads)
    j = torch.searchsorted(_signed_view(right_sorted), _signed_view(left_sorted), right=True) - 1
    has = j >= 0
    s = j.clamp(min=0)

    def at(col, dead):
        return torch.where(has, col.view(torch.int32)[s], dead).view(torch.uint32)

    return has, at(right_sorted, -1), tuple(at(p, 0) for p in right_payloads)


def _launch(left, right, payloads):
    global LAUNCHES
    if not all(t.is_contiguous() for t in (left, right, *payloads)):
        raise ValueError("merge_probe planes must be contiguous")
    dev = left.device
    nl, nr = left.shape[0], right.shape[0]
    has = torch.empty(nl, dtype=torch.bool, device=dev)
    pkey = torch.empty(nl, dtype=torch.uint32, device=dev)
    outs = tuple(torch.empty(nl, dtype=torch.uint32, device=dev) for _ in payloads)
    if nl == 0:
        return has, pkey, outs
    arr = ctypes.c_void_p * len(payloads)
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_merge_probe_u32(
            left.data_ptr(), nl, right.data_ptr(), nr,
            arr(*[t.data_ptr() for t in payloads]), len(payloads),
            has.data_ptr(), pkey.data_ptr(), arr(*[t.data_ptr() for t in outs]),
            _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "merge_probe")
    LAUNCHES += 1
    return has, pkey, outs


def merge_probe(left_sorted, right_sorted, right_payloads=()):
    """For each sorted uint32 probe key: (has, the greatest build key <= it,
    that key's payloads). Returns new tensors. CUDA tensors go to the kernel
    (on the current stream, without synchronising), CPU tensors to
    ``merge_probe_ref``."""
    right_payloads = tuple(right_payloads)
    dev = _check(left_sorted, right_sorted, right_payloads)
    if dev.type == "cpu":
        return merge_probe_ref(left_sorted, right_sorted, right_payloads)
    return _launch(left_sorted, right_sorted, right_payloads)
