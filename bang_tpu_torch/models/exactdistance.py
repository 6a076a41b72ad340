"""BANG_Exactdistance variant: device-resident graph, exact-L2 traversal, no
PQ (port of bang_tpu/models/exactdistance.py).

Reference behavior (BANG_Exactdistance/parANN.cu:90-998): the graph index
lives on the accelerator; traversal distances are exact L2 against the
full-precision vectors; there is no re-rank — the distance-sorted worklist
head is the answer (parANN.cu:1273-1276).

On CUDA tensors a search is one launch of its captured graph
(models/compiled.py); on CPU tensors the eager loop runs
(`search_exact_eager`, the captured loop's plain version).
"""

from __future__ import annotations

import torch

from bang_tpu_torch.device import assert_exact_float32
from bang_tpu_torch.models import compiled
from bang_tpu_torch.models.entry import entry_points
from bang_tpu_torch.models.index import DeviceIndex, layout_of
from bang_tpu_torch.models.traversal import (
    SearchStats,
    check_params,
    make_exact_distance_fn,
    start_traversal,
    traverse,
)
from bang_tpu_torch.utils.config import SearchParams


def prepare_exact(index: DeviceIndex, queries, params: SearchParams):
    """The search's start on the index's device: (step, state, None), the
    traversal's body and initial state (traversal.start_traversal).

    The fetch follows the index layout: K3 over the fused exact rows, the
    nbr_vecs rows, or the scattered vectors. `traversal_precision` takes
    both of its values and both compute in full float32 (TF32 stays off,
    device.py): "default" is a TPU matrix-unit setting (bf16 passes) that
    the bench passes for speed; on the card u8 distances are exact either
    way.

    pq_impl names a PQ lookup, which this variant has none of, so "pallas"
    and "xla" leave the fetch as "auto" does, as in the JAX package; there
    "pallas_dma" selects the in-kernel read of the fused exact rows, which
    is what K3 does here, so it needs those rows and raises without them,
    with JAX's message."""
    check_params(params)
    assert_exact_float32()
    if params.pq_impl == "pallas_dma" and index.fused_vec_rows is None:
        raise ValueError(
            "dma_frontier=True requires fused exact-frontier rows "
            "(pack_exact_frontier_rows); this index has none — build with "
            "fused_exact_frontier=True or use the default path"
        )
    dev = index.vectors.device
    queries_f32 = torch.as_tensor(queries, device=dev).float()
    q = queries_f32.shape[0]
    distance_fn = make_exact_distance_fn(
        queries_f32, index.vectors, nbr_vecs=index.nbr_vecs,
        nbr_vec_norms=index.nbr_vec_norms, fused_vec_rows=index.fused_vec_rows,
    )
    entry_ids, entry_dists = entry_points(index, queries_f32, params)
    step, state = start_traversal(
        index.adj, distance_fn, index.medoid, q, params.L, params.max_iters,
        params.beam_width, dev, entry_ids=entry_ids, entry_dists=entry_dists,
        use_bloom=params.visited_mode == "bloom",
    )
    return step, state, None


def finish_exact(final, params: SearchParams):
    """(ids [Q, k] int32, dists [Q, k] f32): the worklist's head (no
    re-rank)."""
    return final.wl_ids[:, : params.k], final.wl_dist[:, : params.k]


def search_exact(index: DeviceIndex, queries, params: SearchParams):
    """Batched exact-distance search on the index's device: on a CUDA index
    the captured graph of the index's graph cache (models/compiled.py; the
    first call of a search shape runs the eager loop, then captures), on a
    CPU index the eager loop.

    queries: [Q, D] tensor or numpy array. Returns (ids [Q, k] int32,
    dists [Q, k] f32 squared L2, SearchStats), on the device, with no host
    wait."""
    dev = index.vectors.device
    if dev.type != "cuda":
        return search_exact_eager(index, queries, params)
    q = torch.as_tensor(queries)
    (ids, dists), stats = compiled.search(
        index, ("exactdistance", layout_of(index), tuple(q.shape), params), q, dev,
        params.max_iters,
        lambda qs: prepare_exact(index, qs, params),
        lambda _, final: finish_exact(final, params))
    return ids, dists, stats


def search_exact_eager(index: DeviceIndex, queries, params: SearchParams):
    """search_exact on the eager loop (traversal.traverse, one host read a
    step), on any device: the CPU's search and the captured loop's plain
    version."""
    step, state, _ = prepare_exact(index, queries, params)
    final = traverse(step, state, params.max_iters)
    return (*finish_exact(final, params),
            SearchStats(final.it, final.n_expanded, final.n_dist_comps))
