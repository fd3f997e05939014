"""The benchmark of ``safepy_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Nothing here imports ``jax`` or the JAX package; ``reference/`` imports
nothing of the port either.
"""
