"""Device compute paths (counterpart of ``dpu_olap_tpu/ops``).

  sort_cuda   - radix sort, csrc/radix_sort.cu (ops/sort_pallas.py:sort_bitonic), and
                the bitonic tile stage, csrc/sort.cu
  take_cuda   - sorted gather, csrc/gather.cu  (ops/take_pallas.py:gather_sorted_pallas),
                and the sorted-stream take    (take_pallas.py:take_sorted*)
  filter_cuda - filter compaction, csrc/filter.cu (ops/filter_pallas.py v1)
  filter_alt_cuda - the filter alternates v2, v3, v4, csrc/filter2.cu,
                filter3.cu, filter4.cu (ops/filter_pallas2.py, filter_pallas3.py,
                filter_pallas4.py)
  filter_stages - v1 cut at a stage, csrc/filter.cu (scripts/measure_filter.py _variant)
  sum_cuda    - exact u64 sum, csrc/sum.cu    (ops/aggregate.py:_sum_pallas_pair)
  scan_cuda   - forward fill, csrc/scan.cu    (ops/scan_pallas.py:propagate_fill,
                propagate_last)
  fill_match_cuda - the co-sort joins' fill and match, csrc/scan.cu (no TPU
                kernel of its own: propagate_fill fused with the glue around it)
  fill_match_compact_cuda - its compacting form, the matched rows only,
                csrc/scan.cu (no TPU kernel of its own)
  bitonic_cuda - in-block merge cascade, csrc/sort.cu
                                              (ops/bitonic_pallas.py:bitonic_merge_blocks)
  partition_cuda - radix partition into padded cells, csrc/partition.cu
                                              (ops/partition_pallas.py:partition_cells_pallas)
  merge_cuda  - merge-probe, csrc/merge_probe.cu (ops/merge_pallas.py:merge_probe_pallas)
  filter      - filter_compact / filter_with_indices (ops/filter.py)
  aggregate   - sums, min/max, aggregators    (ops/aggregate.py)
  take        - row gather, take_fast         (ops/take.py)
  merge       - bitonic merge, sorted-build and dense-pk joins (ops/merge_xla.py)
  join        - fused co-sort join, join_shard_auto, join_shard (ops/join.py)
  partition   - radix_partition, the cell layout (ops/partition.py)
  hashing     - Wang hash, radix bucket       (ops/hashing.py)
  hashtable   - EMPTY, the cuckoo table and the sorted store (ops/hashtable.py)
  _kernels   - nvcc build + ctypes loading of csrc/*.cu

Modules import no kernel library and run no compiler until a CUDA tensor
reaches a wrapper.
"""
