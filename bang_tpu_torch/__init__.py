"""bang_tpu_torch — the PyTorch/CUDA port of bang_tpu for one NVIDIA H100.

The JAX package `bang_tpu` is the reference and stays as it is; this package
mirrors its module paths and function names so each counterpart is found by
name. It imports `torch` and never `jax`: the numpy-only layers of bang_tpu
(`formats/{bin_io,graph,pq,synthetic,preprocess}.py`,
`utils/{config,recall,logging}.py`, `constants.py`) are the on-disk
contract both packages share, and the port imports them as they are.

Slices ported so far: the in-memory PQ search (BANG_Inmemory) and the
exact-distance search (BANG_Exactdistance) end to end — PQ tables, the
traversal loop with medoid or sampled entries, exact re-rank, the
`BANGSearch("inmemory" | "exactdistance")` facade — and the builders a
bench bundle needs, the Vamana graph included. Every Pallas kernel on those
paths has a hand-written CUDA kernel under `csrc/` (see `ops/pq_kernels.py`
and `ops/exact_kernels.py`).

Importing the package turns TF32 off for float32 matmuls and convolutions:
the JAX path computes its tables and distances at `Precision.HIGHEST`.
"""

from bang_tpu_torch.device import set_exact_float32

set_exact_float32()

from bang_tpu_torch.api import BANGSearch  # noqa: E402,F401
