"""Device compute paths (counterpart of ``dpu_olap_tpu/ops``).

  sort_cuda  - bitonic sort, csrc/sort.cu   (ops/sort_pallas.py:sort_bitonic)
  take_cuda  - sorted gather, csrc/gather.cu (ops/take_pallas.py:gather_sorted_pallas)
  merge      - the dense-pk join            (ops/merge_xla.py:join_shard_dense)
  hashtable  - the EMPTY sentinel           (ops/hashtable.py)
  _kernels   - nvcc build + ctypes loading of csrc/*.cu

Modules import no kernel library and run no compiler until a CUDA tensor
reaches a wrapper.
"""
