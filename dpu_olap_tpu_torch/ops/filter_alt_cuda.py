"""Stable compaction of uint32 values below a threshold: the filter
alternates v2, v3 and v4, three Hopper designs of v1's function
(``ops/filter_cuda.py``), each the counterpart of one TPU alternate:

  v2  ``csrc/filter2.cu`` (``dpu_olap_tpu/ops/filter_pallas2.py``:
      ``filter_compact_pallas2`` and ``filter_with_indices_pallas2``,
      ``_call`` at :220): an output-driven gather in one pass. The tile
      prefix in shared memory, a decoupled look-back for the tile offset, a
      binary search per output slot.
  v3  ``csrc/filter3.cu`` (``filter_pallas3.py``: ``filter_compact_pallas3``,
      ``filter_pallas3_padded`` and ``filter_with_indices_pallas3``,
      ``_call`` at :215): compaction staged in shared memory and written
      out whole, on v1's one-sweep skeleton (a ticket, a warp look-back, a
      tail pass). Per tile: each warp's kept values to the front of its
      slice of shared memory, the warps' runs packed, the run stored with
      16-byte writes.
  v4  ``csrc/filter4.cu`` (``filter_pallas4.py``: ``filter_compact_pallas4``,
      ``filter_pallas4_padded`` and ``filter_with_indices_pallas4``,
      ``_call`` at :200): the scan and the inverse map on the tensor cores.
      A tile count and a one-block scan (``csrc/filter_tiles.cuh``), then
      per 16x16 fragment: the in-row prefix,
      the row starts and each output slot's source row as exact counting
      products with wmma, a front-compaction of each row and a gather.

``filter_compact``, ``filter_padded`` and ``filter_with_indices`` take the
version and launch its kernel for CUDA tensors and run its plain version
for CPU tensors; any other device raises. The contract is v1's with
``threshold`` a runtime argument:
  * ``(padded_values, count)``: ``padded_values[:count]`` are the values
    ``v < threshold`` in input order, ``padded_values[count:] == fill``;
  * ``(values, indices, count)``: the same with ``fill`` 0, and the row
    number of each kept value, the index tail equal to ``n``;
  * ``count`` is a 0-d uint32 tensor on the input's device.
Any length below 2^32. The TPU kernels take only whole blocks (v2 and v3 n
a multiple of 128·r, v4 of halves·16384) and leave their tails undefined;
``block_rows`` and ``halves`` only size their grids and have no
counterpart.

v2's plain version is the gather form of the function, independent of
``filter_cuda.compact_scatter``: the inclusive mask prefix, then for each
output slot t the first row whose prefix exceeds t
(``torch.searchsorted(prefix, t, right=True)``), in int64. v3's and v4's
are ``compact_scatter``. ``LAUNCHES[version]`` counts a version's kernel
launches.
"""

from __future__ import annotations

import torch

from . import filter_cuda
from .filter_cuda import THRESHOLD, _as_i32, below, check_threshold, compact_scatter, on_cpu

VERSIONS = ("v2", "v3", "v4")
TILE = 4096  # elements per block of each kernel (csrc/filter2.cu, filter3.cu, filter_tiles.cuh TILE)
# version: (C entry point, scratch dtype, scratch words beyond one a tile).
# v2's scratch is the tile ticket, then one (flag, value) status word a
# tile; v3's is one status word a tile, then the ticket (v1's
# ``filter_plan``); v4's is the tile offsets.
_ENTRIES = {
    "v2": ("dpu_filter2_u32", torch.int64, 1),
    "v3": ("dpu_filter3_u32", torch.int64, 1),
    "v4": ("dpu_filter4_u32", torch.uint32, 0),
}
LAUNCHES = dict.fromkeys(VERSIONS, 0)  # kernel launches of each version


def _check_version(version: str) -> None:
    if version not in VERSIONS:
        raise ValueError(f"filter version must be one of {VERSIONS}, got {version!r}")


def scratch_words(version: str, n: int) -> int:
    """The words of ``version``'s scratch for a call of n values (at least
    one, so that a call of none still gets a pointer)."""
    _check_version(version)
    return max(1, -(-n // TILE) + _ENTRIES[version][2])


def _gather_form(values: torch.Tensor, threshold: int, fill: int, with_indices: bool):
    n = values.shape[0]
    dev = values.device
    prefix = torch.cumsum(below(values, threshold), 0)
    count = prefix[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    slot = torch.arange(n, device=dev)
    src = torch.searchsorted(prefix, slot, right=True).clamp_(max=max(n - 1, 0))
    live = slot < count
    out = torch.where(live, values.view(torch.int32)[src], _as_i32(fill)).view(torch.uint32)
    if not with_indices:
        return out, count.to(torch.uint32)
    return out, torch.where(live, src, n).to(torch.uint32), count.to(torch.uint32)


def _ref(values: torch.Tensor, version: str, threshold: int, fill: int, with_indices: bool):
    _check_version(version)
    if version == "v2":
        return _gather_form(values, threshold, fill, with_indices)
    return compact_scatter(values, below(values, threshold), fill, with_indices=with_indices)


def filter_compact_ref(values: torch.Tensor, version: str, threshold: int = THRESHOLD,
                       fill: int = 0):
    """Plain PyTorch version of filter_compact."""
    return _ref(values, version, threshold, fill, with_indices=False)


def filter_with_indices_ref(values: torch.Tensor, version: str, threshold: int = THRESHOLD):
    """Plain PyTorch version of filter_with_indices."""
    return _ref(values, version, threshold, 0, with_indices=True)


def _run(values: torch.Tensor, version: str, threshold: int, fill: int, with_indices: bool):
    _check_version(version)
    thr = check_threshold(threshold)
    if on_cpu(values, f"filter {version}"):
        return _ref(values, version, thr, fill, with_indices)
    entry, dtype, _ = _ENTRIES[version]
    scratch = torch.empty(scratch_words(version, values.shape[0]), dtype=dtype,
                          device=values.device)
    res = filter_cuda.run_entry(entry, values, thr, fill, with_indices, scratch,
                                f"filter {version}")
    LAUNCHES[version] += 1
    return res


def filter_compact(values: torch.Tensor, version: str, threshold: int = THRESHOLD,
                   fill: int = 0):
    """(padded_values, count) of the stable compaction of ``values <
    threshold`` by ``version``'s kernel. CUDA tensors go to the kernel (on
    the current stream, without synchronising), CPU tensors to
    ``filter_compact_ref``."""
    return _run(values, version, threshold, fill, with_indices=False)


def filter_padded(values: torch.Tensor, version: str, fill: int = 0):
    """filter_pallas{3,4}_padded: the compaction of ``values < 2^30`` with
    the tail ``fill``. The TPU wrappers pad to their block and poison the
    tail; the kernels here take any length and write the tail themselves."""
    return filter_compact(values, version, THRESHOLD, fill)


def filter_with_indices(values: torch.Tensor, version: str, threshold: int = THRESHOLD):
    """(padded_values, padded_indices, count): filter_compact with fill 0,
    plus the kept rows' numbers (tail n)."""
    return _run(values, version, threshold, 0, with_indices=True)
