"""dpu_olap_tpu_torch — the PyTorch/CUDA port of dpu_olap_tpu.

The same query engine on an NVIDIA H100: columnar Batch/Table over torch
tensors, the seed-42 generator, and the operators with the reference's
Prepare()/Run()/Timers() protocol. Every Pallas kernel of the JAX package
gets a hand-written Hopper counterpart under ``csrc/``; each wrapper runs
its plain PyTorch version for CPU tensors. The JAX package stays the
reference this port is tested against; this package never imports jax.

  - ``ops/``       kernel wrappers and the device compute paths
                   (counterpart of ``dpu_olap_tpu/ops``).
  - ``csrc/``      the CUDA sources, built with nvcc at first use.
  - ``parallel/``  DeviceSet over a torch device (``dpu_olap_tpu/parallel``).
  - ``operators/`` the operators (``dpu_olap_tpu/operators``).
  - ``native/``    the host runtime (its own copy of the JAX package's
                   ``runtime.cpp``, built with g++ at first use): threaded
                   staging copies, partition slabs, timers, the executor.
  - ``plan``       the query plan: Source, Filter, Project, HashJoin,
                   Aggregate, TakeNode, Repartition (``dpu_olap_tpu/plan.py``).
  - ``bench/``     chained device timing and the filter-kernel measurement
                   (``dpu_olap_tpu/bench``, ``scripts/measure_filter.py``).
  - ``columnar``, ``generator``, ``config``, ``timer``, ``metrics``: the
    counterparts of the JAX package's modules of the same names.
"""

__version__ = "0.1.0"
