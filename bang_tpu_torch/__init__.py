"""bang_tpu_torch — the PyTorch/CUDA port of bang_tpu for one NVIDIA H100.

The JAX package `bang_tpu` is the reference and stays as it is; this package
mirrors its module paths and function names so each counterpart is found by
name. It stands alone: it imports `torch` and numpy, never `jax` and nothing
of `bang_tpu`. What it needs of the JAX package's numpy layers it keeps as
its own copies under the same names (`constants.py`,
`formats/{bin_io,graph,pq,synthetic,preprocess}.py`,
`utils/{config,recall,logging}.py`, and the host gather's C++ source in
`native/`). Files are the contract between the two
packages: the copies write the same bytes, and each package reads what the
other wrote.

Slices ported so far: the in-memory PQ search (BANG_Inmemory), the
exact-distance search (BANG_Exactdistance) and the billion-scale base
search (BANG_Base: the graph in host RAM, a native host gather, one CUDA
stream per query sub-batch) end to end — PQ tables, the traversal loop with
medoid or sampled entries, exact re-rank, the `BANGSearch("base" |
"inmemory" | "exactdistance")` facade, the harness CLI
(`python -m bang_tpu_torch.harness.driver`) — the builders a bench bundle
needs, the Vamana graph included, the layout probes of the JAX
package's `scripts/` (`bang_tpu_torch.scripts`), and what lies past one
card: `parallel/` (node-sharded and data-parallel search, the
chunk-sharded PQ lookup and base variant, on a single-controller mesh of
torch devices), `formats/bigbuild.py` (the sharded Vamana build),
`formats/preprocess.py` (the DiskANN converter) and
`entry.dryrun_multichip`. Every Pallas kernel of the
repo has a hand-written CUDA kernel under `csrc/` (see `ops/pq_kernels.py`,
`ops/exact_kernels.py` and `ops/probe_kernels.py`).

Importing the package turns TF32 off for float32 matmuls and convolutions:
the JAX path computes its tables and distances at `Precision.HIGHEST`.
"""

from bang_tpu_torch.device import set_exact_float32

set_exact_float32()

from bang_tpu_torch.api import BANGSearch  # noqa: E402,F401
