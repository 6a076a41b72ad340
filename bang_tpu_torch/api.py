"""Public search API: the `BANGSearch` facade (port of bang_tpu/api.py).

The reference's 7-method lifecycle (BANG_Base/bang.h:53-82):
    bang_load -> bang_set_searchparams -> bang_alloc -> bang_init ->
    bang_query -> bang_free -> bang_unload
with L2 / MIPS distance functions (bang.h:26-30), over the three variants:
"base" (host-RAM graph, PQ codes on the device; models/base.py),
"inmemory" and "exactdistance" (all on the device).

`bang_alloc(Q)` captures, as the JAX facade's compiles: one search at the
batch shape runs the eager loop (it builds the kernels and fills the
caching allocator), then, on the card, captures the search as CUDA graphs
(models/compiled.py for the HBM variants: one graph launch a search, its
loop a WHILE node; models/base.py: one graph a sub-batch's step), and Q is
recorded. With ENABLE_CACHE_WARMUP it first runs
`utils/graph_tools.warmup_touch` (the reference's BFS warm-up of the
codes), as the JAX facade does. `bang_query` then pads a smaller batch up
to Q and splits a larger one into batches of Q, as the JAX facade does, so
that every search replays the captured shape; its one blocking wait is the
readback of the ids, distances and counters (`compiled.readback`).
`bang_set_searchparams` with new parameters and `bang_unload` free the
graphs and their memory pools.
"""

from __future__ import annotations

import numpy as np

from bang_tpu_torch.constants import (
    ENABLE_CACHE_WARMUP,
    ENABLE_GPU_STATS,
    ENUM_DIST_L2,
    ENUM_DIST_MIPS,
)
from bang_tpu_torch.device import resolve_device
from bang_tpu_torch.formats.preprocess import preprocess_queries_mips
from bang_tpu_torch.models import compiled
from bang_tpu_torch.utils.config import SearchParams
from bang_tpu_torch.utils.logging import log_message

# result ids are int64 on output for big-ann-benchmarks compatibility
# (reference: result_ann_t = unsigned long, bang.h:23).
RESULT_DTYPE = np.int64

_VARIANTS = ("base", "inmemory", "exactdistance")


class BANGSearch:
    """Facade over the search variants, on an explicit `device`.

    variant: "base" (the default, as in the JAX facade), "inmemory" or
    "exactdistance". device: "cuda" (the default; raises when no CUDA
    device is visible) or "cpu" (the plain PyTorch path the CPU tests use).
    `warmup_touched` holds the node count of the last ENABLE_CACHE_WARMUP
    warm-up (None before one)."""

    def __init__(self, variant: str = "base", dist_func: int = ENUM_DIST_L2,
                 device="cuda"):
        if variant not in _VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.dist_func = dist_func
        self.device = resolve_device(device)
        self._index = None
        self._searcher = None
        self._params: SearchParams | None = None
        self._batch: int | None = None  # bang_alloc's Q
        self.last_stats = None
        self.warmup_touched: int | None = None

    # -- lifecycle ----------------------------------------------------------

    def bang_load(self, index_prefix: str, mmap: bool | None = None,
                  n_pipeline_batches: int | None = None,
                  fused_frontier: bool | None = None,
                  neighbor_vectors: bool | None = None,
                  neighbor_codes: bool | None = None) -> bool:
        """Load the index files for the configured variant.

        base: the packed graph stays on the host, memory-mapped (mmap=None
        or True) or read into RAM (mmap=False); n_pipeline_batches query
        sub-batches are kept in flight (default 4); only the PQ codes go to
        the device. The HBM variants ignore both, as the JAX facade does.

        inmemory / exactdistance: fused_frontier picks the fused layout of
        the variant (PQ rows for inmemory, exact rows for exactdistance):
        None picks it when it applies and fits
        models/index.FUSED_LAYOUT_BUDGET; False forces the scattered layout.
        neighbor_vectors=True (exactdistance only) builds the nbr_vecs
        layout; neighbor_codes=True (inmemory only) the neighbor-aligned
        codes (models/index.py). base has no device layout and refuses
        the three."""
        log_message(f"bang_load({index_prefix}) variant={self.variant} "
                    f"device={self.device}")
        if self.variant == "base":
            if (fused_frontier, neighbor_vectors, neighbor_codes) != (None,) * 3:
                raise ValueError("fused_frontier, neighbor_vectors and neighbor_codes "
                                 "are layouts of the HBM variants; base keeps its "
                                 "graph on the host")
            from bang_tpu_torch.models.base import BaseVariantSearcher

            self._searcher = BaseVariantSearcher(
                index_prefix,
                n_pipeline_batches=4 if n_pipeline_batches is None else n_pipeline_batches,
                mmap=True if mmap is None else mmap,
                device=self.device,
            )
            return True
        from bang_tpu_torch.models.index import device_index_from_files

        self._index = device_index_from_files(
            index_prefix, self.device, variant=self.variant,
            fused_frontier=fused_frontier, neighbor_vectors=neighbor_vectors,
            neighbor_codes=neighbor_codes,
        )
        return True

    def bang_set_searchparams(
        self, recall_param: int, worklist_length: int, **kwargs
    ) -> None:
        """Set k (recall_param) and L (worklist length); extra kwargs feed
        SearchParams (beam_width, extra_iters, rerank, capabilities, ...).
        Forgets bang_alloc's batch shape; new parameters free the captured
        graphs."""
        params = SearchParams(
            L=worklist_length, k=recall_param, dist_func=self.dist_func, **kwargs
        )
        if params != self._params:
            self._drop_graphs()
        self._params = params
        self._batch = None

    def bang_alloc(self, num_queries: int) -> None:
        """Warm up and capture at this batch shape (one eager search, then
        the CUDA graphs on the card) and record it: later batches are padded
        or split to it. With ENABLE_CACHE_WARMUP the BFS warm-up runs first
        (for base the BFS walks the host records)."""
        if self._params is None:
            raise RuntimeError("call bang_set_searchparams first")
        if self._params.capabilities & ENABLE_CACHE_WARMUP:
            from bang_tpu_torch.utils.graph_tools import warmup_touch

            self.warmup_touched = warmup_touch(
                self._searcher if self.variant == "base" else self._index)
            log_message(f"cache warmup touched {self.warmup_touched} nodes")
        self._run(np.zeros((num_queries, self._dim()), np.float32))
        self._batch = num_queries

    def bang_init(self) -> None:
        """Per-batch state is initialized inside each search; nothing to do
        (kept for lifecycle parity)."""

    def bang_query(self, queries: np.ndarray):
        """Search. queries: [Q, D]; returns (ids [Q, k] int64, dists [Q, k]
        f32), as numpy arrays on the host."""
        if self._params is None:
            raise RuntimeError("call bang_set_searchparams first")
        queries = np.asarray(queries)
        if self.dist_func == ENUM_DIST_MIPS and queries.shape[1] == self._dim() - 1:
            queries = preprocess_queries_mips(queries)
        nq = queries.shape[0]
        cap = self._batch
        if cap is None:
            log_message(f"bang_query at Q={nq} without bang_alloc after the last "
                        "bang_set_searchparams: the warm-up falls into this call")
        elif nq > cap:
            # batches of the warmed-up shape
            outs = [self.bang_query(queries[s : s + cap]) for s in range(0, nq, cap)]
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]))
        elif nq < cap:
            queries = np.concatenate(
                [queries, np.zeros((cap - nq, queries.shape[1]), queries.dtype)])
        ids, dists = self._run(queries)
        return np.asarray(ids)[:nq].astype(RESULT_DTYPE), np.asarray(dists)[:nq]

    def bang_free(self) -> None:
        """Forget bang_alloc's batch shape (the captured graphs stay until
        new parameters or bang_unload)."""
        self._batch = None

    def bang_unload(self) -> None:
        """Free the captured graphs, then drop the index (or base's codes
        and searcher); their device memory returns to PyTorch's caching
        allocator."""
        self._drop_graphs()
        self._index = None
        self._searcher = None
        self._batch = None

    # -- internals ----------------------------------------------------------

    def _drop_graphs(self) -> None:
        if self._searcher is not None:
            self._searcher.drop_graphs()
        if self._index is not None:
            compiled.drop_graphs(self._index)

    def _dim(self) -> int:
        if self.variant == "base":
            return self._searcher.meta.dim
        return self._index.dim

    def _run(self, queries: np.ndarray):
        if self.variant == "base":
            self._searcher.timers.enabled = bool(
                self._params.capabilities & ENABLE_GPU_STATS)
            self.last_stats = None
            return self._searcher.search(queries, self._params)
        if self.variant == "exactdistance":
            from bang_tpu_torch.models.exactdistance import search_exact as search
        else:
            from bang_tpu_torch.models.inmemory import search_inmemory as search

        ids, dists, stats = search(self._index, queries, self._params)
        ids, dists, values = compiled.readback(ids, dists, stats.device_values())
        self.last_stats = stats.sync(values.tolist())
        return ids.numpy(), dists.numpy()
