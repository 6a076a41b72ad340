"""Public search API: the `BANGSearch` facade (port of bang_tpu/api.py).

The reference's 7-method lifecycle (BANG_Base/bang.h:53-82):
    bang_load -> bang_set_searchparams -> bang_alloc -> bang_init ->
    bang_query -> bang_free -> bang_unload
with L2 / MIPS distance functions (bang.h:26-30). The "inmemory" and
"exactdistance" variants are ported; "base" raises NotImplementedError
naming its ROADMAP item.

PyTorch runs eagerly, so there is nothing to compile per shape:
`bang_alloc` runs one warm-up search at the batch shape, which builds the
CUDA kernels (first use) and fills the caching allocator, so that
`bang_query` timings exclude both.
"""

from __future__ import annotations

import numpy as np

from bang_tpu_torch.constants import ENUM_DIST_L2, ENUM_DIST_MIPS
from bang_tpu_torch.device import resolve_device
from bang_tpu_torch.formats.preprocess import preprocess_queries_mips
from bang_tpu_torch.utils.config import SearchParams
from bang_tpu_torch.utils.logging import log_message

# result ids are int64 on output for big-ann-benchmarks compatibility
# (reference: result_ann_t = unsigned long, bang.h:23).
RESULT_DTYPE = np.int64

_NOT_PORTED = {"base": "ROADMAP Queue 1 item 14 (models/base.py)"}
_VARIANTS = ("inmemory", "exactdistance")


class BANGSearch:
    """Facade over the search variants, on an explicit `device`.

    device: "cuda" (the default; raises when no CUDA device is visible) or
    "cpu" (the plain PyTorch path the CPU tests use)."""

    def __init__(self, variant: str = "inmemory", dist_func: int = ENUM_DIST_L2,
                 device="cuda"):
        if variant in _NOT_PORTED:
            raise NotImplementedError(
                f"variant {variant!r} is not ported yet: {_NOT_PORTED[variant]}"
            )
        if variant not in _VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.dist_func = dist_func
        self.device = resolve_device(device)
        self._index = None
        self._params: SearchParams | None = None
        self.last_stats = None

    # -- lifecycle ----------------------------------------------------------

    def bang_load(self, index_prefix: str, fused_frontier: bool | None = None,
                  neighbor_vectors: bool | None = None) -> bool:
        """Load the index files onto the device.

        fused_frontier picks the fused layout of the loaded variant (PQ
        rows for inmemory, exact rows for exactdistance): None picks it when
        it applies and fits models/index.FUSED_LAYOUT_BUDGET; False forces
        the scattered layout. neighbor_vectors=True (exactdistance only)
        builds the nbr_vecs layout instead."""
        from bang_tpu_torch.models.index import device_index_from_files

        log_message(f"bang_load({index_prefix}) variant={self.variant} "
                    f"device={self.device}")
        self._index = device_index_from_files(
            index_prefix, self.device, variant=self.variant,
            fused_frontier=fused_frontier, neighbor_vectors=neighbor_vectors,
        )
        return True

    def bang_set_searchparams(
        self, recall_param: int, worklist_length: int, **kwargs
    ) -> None:
        """Set k (recall_param) and L (worklist length); extra kwargs feed
        SearchParams (beam_width, extra_iters, rerank, ...)."""
        self._params = SearchParams(
            L=worklist_length, k=recall_param, dist_func=self.dist_func, **kwargs
        )

    def bang_alloc(self, num_queries: int) -> None:
        """Warm up at this batch shape (kernel build, allocator)."""
        if self._params is None:
            raise RuntimeError("call bang_set_searchparams first")
        self._run(np.zeros((num_queries, self._index.dim), np.float32))

    def bang_init(self) -> None:
        """Per-batch state is initialized inside each search; nothing to do
        (kept for lifecycle parity)."""

    def bang_query(self, queries: np.ndarray):
        """Search. queries: [Q, D]; returns (ids [Q, k] int64, dists [Q, k]
        f32), as numpy arrays on the host."""
        if self._params is None:
            raise RuntimeError("call bang_set_searchparams first")
        queries = np.asarray(queries)
        if self.dist_func == ENUM_DIST_MIPS and queries.shape[1] == self._index.dim - 1:
            queries = preprocess_queries_mips(queries)
        ids, dists = self._run(queries)
        return ids.cpu().numpy().astype(RESULT_DTYPE), dists.cpu().numpy()

    def bang_free(self) -> None:
        """Search buffers are per call; nothing is held between queries."""

    def bang_unload(self) -> None:
        """Drop the index; its device memory returns to PyTorch's caching
        allocator."""
        self._index = None

    # -- internals ----------------------------------------------------------

    def _run(self, queries: np.ndarray):
        if self.variant == "exactdistance":
            from bang_tpu_torch.models.exactdistance import search_exact as search
        else:
            from bang_tpu_torch.models.inmemory import search_inmemory as search

        ids, dists, stats = search(self._index, queries, self._params)
        self.last_stats = stats
        return ids, dists
