"""Operators (counterpart of ``dpu_olap_tpu/operators``): the
reference's ctor(device_set, inputs...) -> Prepare() -> Run() -> Timers()
protocol, with a Gpu variant and a Native (pyarrow) oracle: ``join_op``
(JoinGpu), ``filter_op`` (FilterGpu), ``aggr_op`` (SumGpu), ``take_op``
(TakeGpu) and ``partition_op`` (PartitionGpu, exported here as the JAX
package exports PartitionTpu)."""

from .partition_op import PartitionGpu

__all__ = ["PartitionGpu"]
