"""Device compute paths (counterpart of ``dpu_olap_tpu/ops``).

  sort_cuda   - bitonic sort, csrc/sort.cu    (ops/sort_pallas.py:sort_bitonic)
  take_cuda   - sorted gather, csrc/gather.cu  (ops/take_pallas.py:gather_sorted_pallas),
                and the sorted-stream take    (take_pallas.py:take_sorted*)
  filter_cuda - filter compaction, csrc/filter.cu (ops/filter_pallas.py v1)
  sum_cuda    - exact u64 sum, csrc/sum.cu    (ops/aggregate.py:_sum_pallas_pair)
  filter      - filter_compact / filter_with_indices (ops/filter.py)
  aggregate   - sums, min/max, aggregators    (ops/aggregate.py)
  take        - row gather, take_fast         (ops/take.py)
  merge       - the dense-pk join             (ops/merge_xla.py:join_shard_dense)
  hashtable   - the EMPTY sentinel            (ops/hashtable.py)
  _kernels   - nvcc build + ctypes loading of csrc/*.cu

Modules import no kernel library and run no compiler until a CUDA tensor
reaches a wrapper.
"""
