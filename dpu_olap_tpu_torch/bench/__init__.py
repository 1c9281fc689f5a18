"""Device timing and measurement entry points (counterpart of
``dpu_olap_tpu/bench`` and of ``scripts/measure_filter.py``).

  device_time    - chained per-op timing, K -> 2K difference (bench/device_time.py)
  measure_filter - the filter kernels' A/B and stage ablation
                   (scripts/measure_filter.py: e2e, parts, v3, v4, defaultab)
"""
