"""Device compute paths (counterpart of ``dpu_olap_tpu/ops``).

  sort_cuda   - bitonic sort, csrc/sort.cu    (ops/sort_pallas.py:sort_bitonic)
  take_cuda   - sorted gather, csrc/gather.cu  (ops/take_pallas.py:gather_sorted_pallas),
                and the sorted-stream take    (take_pallas.py:take_sorted*)
  filter_cuda - filter compaction, csrc/filter.cu (ops/filter_pallas.py v1)
  sum_cuda    - exact u64 sum, csrc/sum.cu    (ops/aggregate.py:_sum_pallas_pair)
  scan_cuda   - forward fill, csrc/scan.cu    (ops/scan_pallas.py:propagate_fill,
                propagate_last)
  bitonic_cuda - in-block merge cascade, csrc/sort.cu
                                              (ops/bitonic_pallas.py:bitonic_merge_blocks)
  filter      - filter_compact / filter_with_indices (ops/filter.py)
  aggregate   - sums, min/max, aggregators    (ops/aggregate.py)
  take        - row gather, take_fast         (ops/take.py)
  merge       - bitonic merge, sorted-build and dense-pk joins (ops/merge_xla.py)
  join        - fused co-sort join, join_shard_auto, join_shard (ops/join.py)
  hashing     - Wang hash                     (ops/hashing.py:wang_hash)
  hashtable   - EMPTY and the cuckoo table    (ops/hashtable.py:54-204)
  _kernels   - nvcc build + ctypes loading of csrc/*.cu

Modules import no kernel library and run no compiler until a CUDA tensor
reaches a wrapper.
"""
