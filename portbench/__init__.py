"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line. Configurations (``configs/``), traffic mixes
(``traffic/``), per-layer metrics (``metrics/``), drivers (``drivers/``)
and the plain references of the cells (``reference/``) are files found by
the names ``BENCHMARK.json`` gives them. Nothing here imports JAX or the
JAX package.
"""
