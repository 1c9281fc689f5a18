"""Take (gather): output[i] = data[indices[i]] (counterpart of
``dpu_olap_tpu/ops/take.py``).

Reference: dpu/shared/kernels/take.c, one 4-byte random load per index
(take.c:27-41). ``take`` is the row gather: a plain clipped index, as the
JAX package's row gather is plain XLA. ``take_fast`` prefers the
sorted-stream path of ``ops/take_cuda.py`` (sort, one streaming pass over
the table, sort back), which runs the sort and gather kernels on CUDA
tensors.

Out-of-range indices clip: every index is read as unsigned 32-bit, and any
index >= n reads data[n-1] (an int32-negative bit pattern included), so all
take paths agree on out-of-range inputs.
"""

from __future__ import annotations

import torch

from .filter_cuda import _as_i32

_VIEWS = {torch.uint32: torch.int32}  # dtypes torch cannot index on the CPU


def _u32_index(indices: torch.Tensor) -> torch.Tensor:
    """Indices read as uint32, widened to int64."""
    return indices.to(torch.int64) & 0xFFFFFFFF


def _clip_u32(indices: torch.Tensor, n: int) -> torch.Tensor:
    """Clip indices to [0, n) through an unsigned view (int64 result)."""
    return _u32_index(indices).clamp(max=n - 1)


def _rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    view = _VIEWS.get(data.dtype)
    if view is None:
        return data[idx]
    return data.view(view)[idx].view(data.dtype)


def _where(mask: torch.Tensor, x: torch.Tensor, fill: int) -> torch.Tensor:
    """Rows of x where mask, else fill (uint32 moves as int32 bits)."""
    mask = mask.reshape(-1, *[1] * (x.dim() - 1))
    if x.dtype == torch.uint32:
        return torch.where(mask, x.view(torch.int32), _as_i32(fill)).view(torch.uint32)
    return torch.where(mask, x, fill)


def take(data: torch.Tensor, indices: torch.Tensor, fill: int | None = None) -> torch.Tensor:
    """Gather rows of ``data`` at ``indices``. With ``fill`` None, indices
    clip to n-1; otherwise rows at indices >= n (read unsigned) are
    ``fill``."""
    n = data.shape[0]
    if n == 0:
        raise ValueError("take needs a non-empty table")
    out = _rows(data, _clip_u32(indices, n))
    if fill is None:
        return out
    return _where(_u32_index(indices) < n, out, fill)


def take_masked(data: torch.Tensor, indices: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Gather with a validity mask: invalid lanes produce 0. Used by padded
    shuffle fragments where tail lanes carry sentinel indices."""
    idx = torch.where(valid, _u32_index(indices), 0)
    return _where(valid, take(data, idx), 0)


def take_fast(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The sorted-stream take (ops/take_cuda.take_sorted) when the shapes
    allow it, else the row gather. The TPU version retries an overflowed
    window; the port's gather has no window, so a non-zero flag is a bug and
    raises."""
    from .take_cuda import take_sorted, takeable_sorted

    if not (
        data.dim() == 1
        and data.element_size() == 4
        and takeable_sorted(data.shape[0], indices.shape[0])
    ):
        return take(data, indices)
    out, flag = take_sorted(data, indices)
    if int(flag) != 0:
        raise RuntimeError("take_sorted reported a gather overflow")
    return out
