"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Everything that belongs to one configuration, traffic mix,
cell or per-layer metric lives in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``cells/<cell>.json``,
``layer_metrics/<metric base name>.py``. Nothing here imports JAX or the
JAX package, and nothing reads ``benchmarks/``.
"""
