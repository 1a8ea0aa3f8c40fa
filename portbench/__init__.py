"""The benchmark of the PyTorch and CUDA port
(``transformer_mm_explainability_tpu_torch``).

``portbench/run.py`` runs one cell of ``BENCHMARK.json`` once and prints
one JSON result line; ``portbench/README.md`` says how cells, traffic mixes
and per-layer metrics are added as files. Nothing here imports JAX or the
JAX package, and ``reference/`` imports nothing of the port.
"""
