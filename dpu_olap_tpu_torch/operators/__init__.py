"""Operators (counterpart of ``dpu_olap_tpu/operators``): the
reference's ctor(device_set, inputs...) -> Prepare() -> Run() -> Timers()
protocol, with a Gpu variant and a Native (pyarrow) oracle. Import the
operator modules directly: ``join_op`` (JoinGpu), ``filter_op``
(FilterGpu), ``aggr_op`` (SumGpu) and ``take_op`` (TakeGpu)."""
