"""gpubench: the benchmark of bang_tpu_torch on one CUDA card.

`python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once (see README.md). Importing this package
imports nothing else: run.py reads the clock first.
"""
