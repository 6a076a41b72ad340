"""BANG_Inmemory variant: device-resident graph + PQ traversal + exact
re-rank (port of bang_tpu/models/inmemory.py).

Reference behavior (BANG_Inmemory/parANN.cu:77-906): graph and PQ codes
live on the accelerator; traversal distances come from per-query PQ
tables; after the walk every expanded node is re-ranked with exact L2
against the full-precision vectors and the top-k is returned.
"""

from __future__ import annotations

import torch

from bang_tpu.utils.config import SearchParams
from bang_tpu_torch.device import assert_exact_float32
from bang_tpu_torch.models.entry import entry_points
from bang_tpu_torch.models.index import DeviceIndex
from bang_tpu_torch.models.traversal import (
    SearchStats,
    check_params,
    make_pq_distance_fn,
    rerank_topk,
    run_traversal,
)


def search_inmemory(index: DeviceIndex, queries, params: SearchParams):
    """Batched PQ-traversal search with exact re-rank on the index's device.

    queries: [Q, D] tensor or numpy array. Returns (ids [Q, k] int32,
    dists [Q, k] f32 squared L2, SearchStats).

    Under entry_mode="sampled" the entries and their worklist seeds come
    from exact distances to a strided sample (models/entry.py); the walk
    itself still runs on PQ distances, as in the JAX package."""
    check_params(params)
    assert_exact_float32()
    dev = index.vectors.device
    queries_f32 = torch.as_tensor(queries, device=dev).float()
    q = queries_f32.shape[0]
    distance_fn = make_pq_distance_fn(
        queries_f32, index.codebook, index.codes, fused_rows=index.fused_rows
    )
    entry_ids, entry_dists = entry_points(index, queries_f32, params)
    final = run_traversal(
        index.adj, distance_fn, index.medoid, q, params.L, params.max_iters,
        params.beam_width, dev, entry_ids=entry_ids, entry_dists=entry_dists,
    )
    if params.rerank:
        ids, dists = rerank_topk(queries_f32, index.vectors, final.visited_ids,
                                 params.k)
    else:
        ids, dists = final.wl_ids[:, : params.k], final.wl_dist[:, : params.k]
    return ids, dists, SearchStats(final.it, final.n_expanded, final.n_dist_comps)
