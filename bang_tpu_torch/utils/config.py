"""Runtime search parameters, copied from bang_tpu/utils/config.py
(`SearchParams` only; the dataset presets are not copied).

The port's functions read a SearchParams' fields and check no class, so
they take bang_tpu's SearchParams as well; both raise on the same invalid
values (tests/test_torch_formats.py).
"""

from __future__ import annotations

import dataclasses

from bang_tpu_torch.constants import DEFAULT_EXTRA_ITERS, ENUM_DIST_L2, MAX_L


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Runtime search parameters (reference: BANG_Base/bang_search.cuh:154-159)."""

    L: int = 64  # worklist (beam) length
    k: int = 10  # neighbors to return
    dist_func: int = ENUM_DIST_L2
    extra_iters: int = DEFAULT_EXTRA_ITERS
    visited_mode: str = "exact"  # "exact" (worklist + visited compare) | "bloom"
    beam_width: int = 1  # parents expanded per iteration (1 = reference schedule)
    rerank: bool = True  # exact re-rank of visited nodes (PQ variants)
    # "auto" | "pallas" | "pallas_dma" | "xla": the JAX package's kernel
    # choice; the port takes only "auto" (models/traversal.check_params)
    pq_impl: str = "auto"
    traversal_precision: str = "highest"  # exact-path cross term: "highest"|"default"
    capabilities: int = 0  # ENABLE_GPU_STATS | ENABLE_CACHE_WARMUP bitmask
    # "medoid" = reference behavior (one shared entry, bang_search.cu:466);
    # "sampled" = per-query entry from a strided sample (models/entry.py)
    entry_mode: str = "medoid"
    entry_samples: int = 1024  # sample size S when entry_mode == "sampled"

    def __post_init__(self):
        if not (1 <= self.L <= MAX_L):
            raise ValueError(f"L must be in [1, {MAX_L}], got {self.L}")
        if self.k > self.L:
            raise ValueError(f"k ({self.k}) must be <= L ({self.L})")
        if self.visited_mode not in ("exact", "bloom"):
            raise ValueError(f"unknown visited_mode {self.visited_mode!r}")
        if self.pq_impl not in ("auto", "pallas", "pallas_dma", "xla"):
            raise ValueError(f"unknown pq_impl {self.pq_impl!r}")
        if self.traversal_precision not in ("highest", "default"):
            raise ValueError(f"unknown traversal_precision {self.traversal_precision!r}")
        if not (1 <= self.beam_width <= 16):
            raise ValueError(f"beam_width must be in [1, 16], got {self.beam_width}")
        if self.entry_mode not in ("medoid", "sampled"):
            raise ValueError(f"unknown entry_mode {self.entry_mode!r}")
        if self.entry_samples < 1:
            raise ValueError("entry_samples must be >= 1")

    @property
    def max_iters(self) -> int:
        # Reference: maxIters = L + NAX_EXTRA_ITERATION (bang_search.cu:53, 370)
        # = the total expansion budget; a wider beam spends it in fewer
        # sequential iterations.
        return -(-(self.L + self.extra_iters) // self.beam_width)
