"""Radix partition into padded cells (counterpart of
``dpu_olap_tpu/ops/partition_pallas.py:partition_cells_pallas``).

``partition_cells`` launches ``csrc/partition.cu`` for CUDA tensors and runs
the plain version ``partition_cells_ref`` for CPU tensors; any other device
raises. Contract (partition_pallas.py:161-237, the local_fragments layout):

  * bucket = wang_hash(key) >> (1 + clz(P)), P a power of two in [2, 16];
  * bucket p's rows land in cells_k[p, :count_p] in input order, with their
    payload planes and (unless dropped) their input row index in cells_sel;
  * counts is the true histogram (uint32), overflow (0-d bool) says some
    count passed the cell; such a bucket keeps its first ``cell_size`` rows;
  * padded lanes hold key 0xFFFFFFFF, payloads 0 and selection 0xFFFFFFFF
    in both versions, so the two agree bit for bit on every lane.

The TPU kernel leaves padded lanes unspecified and, on overflow, reports
clamped running offsets as counts (partition_pallas.py:98, 148); its layout
limits (n a multiple of 32Ki, cell a multiple of 128) have no counterpart:
any n >= 0 and any cell_size >= 1 are taken.

The kernel is a one-sweep pass (``csrc/partition.cu``): tiles of TILE rows
taken by ticket, ranked by ballots, their bucket counts joined by a
decoupled look-back and their rows staged by bucket in shared memory, then
a pad launch. Its work memory, allocated by the wrapper for each call and
freed when it returns, is ``partition_plan``'s: 8 * (P * ceil(n / 4096) +
1) bytes (512 KiB at one SF=64 side: 128Mi rows, P = 2). A call is one
memset and two launches per payload group, with no host synchronisation,
so it can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _kernels
from .partition import lay_cells, radix_partition_with_payload

MAX_PAYLOADS = 8  # payload planes per launch (csrc/partition.cu MAX_PAYLOADS)
TILE = 4096  # elements per block of the kernel (csrc/partition.cu TILE)
LAUNCHES = 0  # kernel launches by partition_cells (the CPU path adds none)


class PartitionPlan(NamedTuple):
    """What one launch of the partition kernel needs beside its outputs, in
    one work buffer of int64 words: the tiles (one block each), then one
    look-back status word per tile and bucket and the ticket (one word)."""

    tiles: int
    work_words: int


def partition_plan(n: int, nr_partitions: int) -> PartitionPlan:
    """The partition kernel's launch plan (csrc/partition.cu dpu_partition_u32)."""
    tiles = -(-n // TILE)
    return PartitionPlan(tiles, nr_partitions * tiles + 1)


def partitionable(nr_partitions: int) -> bool:
    """The kernel takes P a power of two in [2, 16] (the TPU kernel's
    unrolled-butterfly limit, kept so both packages route alike)."""
    return 2 <= nr_partitions <= 16 and nr_partitions & (nr_partitions - 1) == 0


def _check(keys, payloads, nr_partitions: int, cell_size: int) -> torch.device:
    if not partitionable(nr_partitions):
        raise ValueError(f"partition_cells needs P a power of two in [2, 16], got {nr_partitions}")
    if cell_size < 1:
        raise ValueError(f"partition_cells needs cell_size >= 1, got {cell_size}")
    if keys.dtype != torch.uint32 or keys.dim() != 1:
        raise ValueError("partition_cells keys must be a 1-D uint32 tensor")
    for p in payloads:
        if p.dtype != torch.uint32 or p.shape != keys.shape:
            raise ValueError("partition_cells payloads must be 1-D uint32 of the keys' length")
        if p.device != keys.device:
            raise ValueError("partition_cells planes must share one device")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"partition_cells runs on cuda or cpu tensors, got {keys.device}")
    if keys.shape[0] > 0xFFFFFFFF:
        raise ValueError("partition_cells takes fewer than 2^32 rows (uint32 selection)")
    return keys.device


def partition_cells_ref(keys, payloads, nr_partitions: int, cell_size: int, with_sel: bool = True):
    """Plain PyTorch version: the radix partition (a stable sort of the
    bucket) and the padded-cell gather (ops/partition.py). It takes any P >=
    1, and is the partition ``local_fragments`` runs where the kernel's gate
    fails."""
    res, moved = radix_partition_with_payload(keys, tuple(payloads), nr_partitions)
    return lay_cells(res, moved, nr_partitions, cell_size, with_sel=with_sel)


def _launch(keys, payloads, nr_partitions: int, cell_size: int, with_sel: bool):
    global LAUNCHES
    if not all(t.is_contiguous() for t in (keys, *payloads)):
        raise ValueError("partition_cells planes must be contiguous")
    dev = keys.device
    n, p = keys.shape[0], nr_partitions

    def cells():
        return torch.empty((p, cell_size), dtype=torch.uint32, device=dev)

    ck = cells()
    cp = tuple(cells() for _ in payloads)
    sel = cells() if with_sel else None
    counts = torch.empty(p, dtype=torch.uint32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    if n == 0:  # nothing to launch: every lane is a pad
        for c, pad in ((ck, -1), *((c, 0) for c in cp), (sel, -1)):
            if c is not None:
                c.view(torch.int32).fill_(pad)
        counts.view(torch.int32).zero_()
        return ck, cp, sel, counts, torch.zeros((), dtype=torch.bool, device=dev)
    work = torch.empty(partition_plan(n, p).work_words, dtype=torch.int64, device=dev)
    lib = _kernels.library()
    # more than MAX_PAYLOADS planes: one launch per group, each clearing the
    # work memory and writing the same keys, counts and selection again
    groups = [payloads[i:i + MAX_PAYLOADS] for i in range(0, len(payloads), MAX_PAYLOADS)] or [()]
    outs = [cp[i:i + MAX_PAYLOADS] for i in range(0, len(cp), MAX_PAYLOADS)] or [()]
    for g, o in zip(groups, outs):
        arr = ctypes.c_void_p * len(g)
        with torch.cuda.device(dev):
            rc = lib.dpu_partition_u32(
                keys.data_ptr(), arr(*[t.data_ptr() for t in g]), len(g), n, p, cell_size,
                ck.data_ptr(), arr(*[t.data_ptr() for t in o]),
                None if sel is None else sel.data_ptr(),
                counts.data_ptr(), overflow.data_ptr(), work.data_ptr(),
                _kernels.stream_handle(dev),
            )
        _kernels.check(rc, "partition_cells")
        LAUNCHES += 1
    return ck, cp, sel, counts, overflow != 0


def partition_cells(keys, payloads, nr_partitions: int, cell_size: int, with_sel: bool = True):
    """Partition uint32 keys (+ uint32 payload planes) into (P, cell_size)
    padded cells. Returns (cells_k, cells_payloads, cells_sel, counts,
    overflow); cells_sel is None when ``with_sel`` is False. CUDA tensors go
    to the kernel (on the current stream, without synchronising), CPU
    tensors to ``partition_cells_ref``."""
    payloads = tuple(payloads)
    dev = _check(keys, payloads, nr_partitions, cell_size)
    if dev.type == "cpu":
        return partition_cells_ref(keys, payloads, nr_partitions, cell_size, with_sel)
    return _launch(keys, payloads, nr_partitions, cell_size, with_sel)
