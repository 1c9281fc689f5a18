"""The co-sort joins' fill and match in one kernel (``csrc/scan.cu``
fill_match_kernel). No TPU kernel of its own: it fuses
``dpu_olap_tpu/ops/scan_pallas.py:178`` propagate_fill with the JAX
package's fill and match glue around it (``dpu_olap_tpu/ops/merge_xla.py:62``
join_shard_sorted_build, ``dpu_olap_tpu/ops/join.py:128`` join_shard_fused).

``fill_match_k2`` takes the sorted planes led by the packed key k2 = key <<
1 | side of the keys31 joins (ops/merge.py, ops/join.py) and launches the
kernel for CUDA tensors: one sweep of ``scan_cuda``'s fill that decodes k2,
carries each pk row's key and payloads and writes the joined rows and their
mask, with no intermediate plane in device memory. CPU tensors go to
``fill_match_k2_ref``, the plain version: the decode, ``propagate_fill_ref``
and the match, in that order, as the joins ran them before the kernel. Any
other device raises.

Bound: device-memory traffic. k2 and each payload are read once and every
output written once, 4(1 + max(m_l, m_r)) + 4(1 + m_l + m_r) + 1 bytes a
lane: 21 at m_l = m_r = 1, 3.36 ms at 2^29 lanes on an H100's 3.35 TB/s.
The kernel keeps the glue's decoded key, side mask and filled planes in
registers and shared memory, and writes the key and payloads with 16-byte
stores, the mask with 4-byte ones. Its work memory is ``scan_cuda.fill_plan``'s.
"""

from __future__ import annotations

import torch

from . import _kernels
from .scan_cuda import (
    EMPTY,
    _check_planes,
    _pointers,
    fill_plan,
    fill_planes,
    match_filled,
    propagate_fill_ref,
)

LAUNCHES = 0  # kernel launches by fill_match_k2


def _decode_k2(sk2: torch.Tensor) -> tuple:
    """(sk, is_pk) of sorted packed keys k2 = key << 1 | side (side 0 for a
    pk row): k2 >= 0xFFFFFFFE decodes back to EMPTY."""
    k2 = sk2.to(torch.int64)
    return torch.where(k2 >= 0xFFFFFFFE, EMPTY, k2 >> 1), (k2 & 1) == 0


def fill_match_k2_ref(planes, m_l: int, m_r: int) -> tuple:
    """Plain PyTorch version of fill_match_k2."""
    planes = tuple(planes)
    sk, is_pk = _decode_k2(planes[0])
    filled = propagate_fill_ref(fill_planes(sk, is_pk, planes[1:], m_r))
    return match_filled(sk, is_pk, filled, planes[1:], m_l)


def _checked(name: str, planes, m_l: int, m_r: int) -> tuple:
    """(the planes the step reads, their device), or a ValueError."""
    planes = tuple(planes)
    m = max(m_l, m_r)
    if min(m_l, m_r) < 0 or len(planes) < 1 + m:
        raise ValueError(f"{name} needs k2 and max(m_l, m_r) payload planes, got"
                         f" {len(planes)} planes for m_l={m_l}, m_r={m_r}")
    planes = planes[:1 + m]
    dev = _check_planes(name, planes, (torch.uint32,))
    if dev.type == "cuda" and not all(p.is_contiguous() for p in planes):
        raise ValueError(f"{name} planes must be contiguous")
    return planes, dev


def fill_match_k2(planes, m_l: int, m_r: int) -> tuple:
    """The co-sort joins' fill and match over sorted uint32 planes (k2,
    payload 0, ...), k2 = key << 1 | side (pk rows 0), at least max(m_l,
    m_r) payloads (further planes are not read). A lane is a pk row that
    starts a carry where k2 is even and below 0xFFFFFFFE, and matched where
    k2 is odd and the nearest such lane at or before it has its key.
    Returns (key, out_l, out_r, matched), each of the planes' length: the
    key, the first m_l payloads of the lane and the first m_r payloads of
    its pk row where matched, 0 elsewhere; matched bool. CUDA tensors go to
    the kernel (on the current stream, without synchronising), CPU tensors
    to ``fill_match_k2_ref``."""
    global LAUNCHES
    planes, dev = _checked("fill_match_k2", planes, m_l, m_r)
    if dev.type == "cpu":
        return fill_match_k2_ref(planes, m_l, m_r)
    n = planes[0].shape[0]
    key = torch.empty(n, dtype=torch.uint32, device=dev)
    out_l = tuple(torch.empty(n, dtype=torch.uint32, device=dev) for _ in range(m_l))
    out_r = tuple(torch.empty(n, dtype=torch.uint32, device=dev) for _ in range(m_r))
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return key, out_l, out_r, matched
    work = torch.empty(fill_plan(n).work_words, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _kernels.library().dpu_fill_match_u32(
            _pointers(planes), m_l, m_r, n, key.data_ptr(), _pointers(out_l), _pointers(out_r),
            matched.data_ptr(), work.data_ptr(), _kernels.stream_handle(dev),
        )
    _kernels.check(rc, "fill_match_k2")
    LAUNCHES += 1
    return key, out_l, out_r, matched
