"""Sum aggregation with exact uint64 results, and the pluggable aggregators
(counterpart of ``dpu_olap_tpu/ops/aggregate.py``).

Reference: dpu/shared/kernels/aggr.c + dpu/aggr/main.c:38-51 — uint32
inputs accumulated into uint64 partial sums, summed across DPUs on the host
(host/aggr/aggr_dpu.cc:82-84). The exact integer sum runs in the kernel of
``ops/sum_cuda.py`` on CUDA tensors; everything else here is plain PyTorch,
as it is plain XLA in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..metrics import count
from . import sum_cuda

_FBLOCK = 1 << 13  # f32 partial-sum block of the float path


def _as_u32(values: torch.Tensor) -> torch.Tensor:
    """values.astype(uint32).reshape(-1): a uint32 column as it is, any
    other integer column by its low 32 bits."""
    v = values.reshape(-1)
    if v.dtype == torch.uint32:
        return v
    return (v.to(torch.int64) & 0xFFFFFFFF).to(torch.uint32)


def sum_u64_pair(values: torch.Tensor):
    """Exact uint64 sum of a uint32 column as a (lo32, hi32) pair of 0-d
    uint32 tensors; on CUDA tensors one launch of the sum kernel."""
    return sum_cuda.sum_u64_pair(_as_u32(values))


def u64_pair_to_int(lo, hi) -> int:
    """The sum's (lo, hi) pair as one int: two readbacks of device scalars,
    counted as ``readback.aggregate.u64``."""
    count("readback.aggregate.u64", 2)
    return (int(hi) << 32) | int(lo)


def sum_u64(values: torch.Tensor) -> int:
    """Host-visible exact sum (device reduction + 2-scalar readback)."""
    lo, hi = sum_u64_pair(values)
    return u64_pair_to_int(lo, hi)


# Floating-point (Double) variant: the reference instantiates
# AggrNative<UInt64Array> and <DoubleArray> (host/aggr/aggr_native.cc:95-96).
# As in the JAX package, the device computes f32 partial sums over blocks of
# 2^13 and the host combines them in f64; the summation order differs from
# XLA's, so results agree to a relative 1e-5, not bit for bit.


def sum_f64_partials(values: torch.Tensor) -> torch.Tensor:
    """Per-block f32 partial sums of a float column (device side)."""
    v = values.reshape(-1).to(torch.float32)
    pad = (-v.shape[0]) % _FBLOCK
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return v.reshape(-1, _FBLOCK).sum(dim=1, dtype=torch.float32)


def sum_f64(values: torch.Tensor) -> float:
    """Double sum: device f32 block partials + host f64 combine."""
    parts = sum_f64_partials(values).cpu().numpy().astype(np.float64)
    return float(parts.sum())


def min_u32(values: torch.Tensor) -> torch.Tensor:
    return _as_u32(values).to(torch.int64).min().to(torch.uint32)


def max_u32(values: torch.Tensor) -> torch.Tensor:
    return _as_u32(values).to(torch.int64).max().to(torch.uint32)


# The reference's kernel_aggr takes a fold function (dpu/shared/kernels/
# aggr.h:9-25) with AggrSum as the one registered aggregator; the same
# plug-in surface, over whole columns.
AGGREGATORS = {
    "sum": lambda v: sum_u64(v),
    "sum_double": lambda v: sum_f64(v),
    "min": lambda v: int(min_u32(v)),
    "max": lambda v: int(max_u32(v)),
    "count": lambda v: int(v.shape[0]),
}


def aggregate(values: torch.Tensor, agg: str = "sum") -> int | float:
    """Run a registered aggregator (AggrSum dispatch analog)."""
    try:
        fn = AGGREGATORS[agg]
    except KeyError:
        raise ValueError(f"unknown aggregator {agg!r}; have {sorted(AGGREGATORS)}") from None
    return fn(values)
