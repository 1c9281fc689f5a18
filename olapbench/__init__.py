"""The benchmark of ``dpu_olap_tpu_torch``, the PyTorch and CUDA query engine.

    python3 -m olapbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once on the CUDA devices it needs and
prints one JSON line. Everything a cell is made of is found by name:
``configs/`` (deployments), ``traffic/`` (mixes), ``queries/`` (the
program's call each mix names), ``data/`` (tables made from the seed),
``metrics/`` (one reader a metric), ``reference/`` (the plain reference the
answers are held to). ``tests/`` holds its CPU tests and, marked ``cuda``,
its card tests (``python -m pytest olapbench/tests``); ``tests/cells.py``
also reads, seed by seed, the numbers the check's limits are set from. It imports nothing of JAX or
of the JAX package ``dpu_olap_tpu``.
"""
