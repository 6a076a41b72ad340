"""BANG_Exactdistance variant: device-resident graph, exact-L2 traversal, no
PQ (port of bang_tpu/models/exactdistance.py).

Reference behavior (BANG_Exactdistance/parANN.cu:90-998): the graph index
lives on the accelerator; traversal distances are exact L2 against the
full-precision vectors; there is no re-rank — the distance-sorted worklist
head is the answer (parANN.cu:1273-1276).
"""

from __future__ import annotations

import torch

from bang_tpu_torch.device import assert_exact_float32
from bang_tpu_torch.models.entry import entry_points
from bang_tpu_torch.models.index import DeviceIndex
from bang_tpu_torch.models.traversal import (
    SearchStats,
    check_params,
    make_exact_distance_fn,
    run_traversal,
)
from bang_tpu_torch.utils.config import SearchParams


def search_exact(index: DeviceIndex, queries, params: SearchParams):
    """Batched exact-distance search on the index's device.

    queries: [Q, D] tensor or numpy array. Returns (ids [Q, k] int32,
    dists [Q, k] f32 squared L2, SearchStats).

    The fetch follows the index layout: K3 over the fused exact rows, the
    nbr_vecs rows, or the scattered vectors. `traversal_precision` takes
    both of its values and both compute in full float32 (TF32 stays off,
    device.py): "default" is a TPU matrix-unit setting (bf16 passes) that
    the bench passes for speed; on the card u8 distances are exact either
    way."""
    check_params(params)
    assert_exact_float32()
    dev = index.vectors.device
    queries_f32 = torch.as_tensor(queries, device=dev).float()
    q = queries_f32.shape[0]
    distance_fn = make_exact_distance_fn(
        queries_f32, index.vectors, nbr_vecs=index.nbr_vecs,
        nbr_vec_norms=index.nbr_vec_norms, fused_vec_rows=index.fused_vec_rows,
    )
    entry_ids, entry_dists = entry_points(index, queries_f32, params)
    final = run_traversal(
        index.adj, distance_fn, index.medoid, q, params.L, params.max_iters,
        params.beam_width, dev, entry_ids=entry_ids, entry_dists=entry_dists,
        use_bloom=params.visited_mode == "bloom",
    )
    return (final.wl_ids[:, : params.k], final.wl_dist[:, : params.k],
            SearchStats(final.it, final.n_expanded, final.n_dist_comps))
