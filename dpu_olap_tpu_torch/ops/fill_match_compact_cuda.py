"""The co-sort joins' fill and match with the compaction of the matched rows
in the same kernel (``csrc/scan.cu`` fill_match_kernel's compacting form).
No TPU kernel of its own: ``fill_match_cuda.fill_match_k2`` followed by the
query plan's compaction (the filter over the match mask and the takes).

``fill_match_compact_k2`` takes the planes of ``fill_match_k2`` and writes
only the matched lanes' key and payloads, in lane order, and their count as
a device word, so no mask, no padded plane and no filter or gather pass over
them reach device memory. CPU tensors go to ``fill_match_compact_k2_ref``:
``fill_match_k2_ref``, then the matched rows.

Bound: device-memory traffic. 4(1 + max(m_l, m_r)) bytes a lane read and
4(1 + m_l + m_r) a matched lane written: 14 a lane at m_l = m_r = 1 with
half the lanes matched, 2.24 ms at 2^29 lanes on an H100's 3.35 TB/s. Its
work memory is twice ``scan_cuda.fill_plan``'s: a carry word a tile and the
ticket, then a count word a tile and the total.
"""

from __future__ import annotations

import torch

from . import _kernels
from .fill_match_cuda import _checked, fill_match_k2_ref
from .scan_cuda import _pointers, fill_plan

LAUNCHES = 0  # kernel launches by fill_match_compact_k2


def compact_words(n: int) -> int:
    """The compacting kernel's work words at n lanes: fill_plan's (a carry
    word a tile and the ticket), then a count word a tile and the total."""
    return 2 * fill_plan(n).work_words


def fill_match_compact_k2_ref(planes, m_l: int, m_r: int, capacity: int) -> tuple:
    """Plain PyTorch version of fill_match_compact_k2, on the planes' device:
    fill_match_k2_ref, then the matched rows (rows past the count are 0)."""
    key, out_l, out_r, matched = fill_match_k2_ref(planes, m_l, m_r)
    count = int(matched.sum())
    kept = min(count, capacity)

    def rows(p):
        out = torch.zeros(capacity, dtype=torch.int32, device=p.device)
        out[:kept] = p.view(torch.int32)[matched][:kept]
        return out.view(torch.uint32)

    return (rows(key), tuple(map(rows, out_l)), tuple(map(rows, out_r)),
            torch.tensor(count, dtype=torch.int64, device=key.device))


def fill_match_compact_k2(planes, m_l: int, m_r: int, capacity: int) -> tuple:
    """fill_match_k2 followed by the compaction of its matched rows, in one
    kernel: returns (key, out_l, out_r, count), where row i of key and of
    each payload plane is the i-th matched lane's, in lane order, and count
    is the number of matched lanes, a 0-d int64 tensor on the planes'
    device. The planes have ``capacity`` rows; rows at and past count hold
    nothing defined, and a count above capacity means that rows were not
    written: a join's probe rows each match at most once, so their number is
    a safe capacity. CUDA tensors go to the kernel (one memset and one
    launch on the current stream, without synchronising or a host decision,
    so a CUDA graph can replay it), CPU tensors to
    ``fill_match_compact_k2_ref``."""
    global LAUNCHES
    planes, dev = _checked("fill_match_compact_k2", planes, m_l, m_r)
    if capacity < 0:
        raise ValueError(f"fill_match_compact_k2 needs a capacity >= 0, got {capacity}")
    if dev.type == "cpu":
        return fill_match_compact_k2_ref(planes, m_l, m_r, capacity)
    n = planes[0].shape[0]

    def plane():
        return torch.empty(capacity, dtype=torch.uint32, device=dev)

    key = plane()
    out_l = tuple(plane() for _ in range(m_l))
    out_r = tuple(plane() for _ in range(m_r))
    if n == 0:
        return key, out_l, out_r, torch.zeros((), dtype=torch.int64, device=dev)
    work = torch.empty(compact_words(n), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_fill_match_compact_u32(
            _pointers(planes), m_l, m_r, n, capacity, key.data_ptr(), _pointers(out_l),
            _pointers(out_r), work.data_ptr(), _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "fill_match_compact_k2")
    LAUNCHES += 1
    return key, out_l, out_r, work[-1]
