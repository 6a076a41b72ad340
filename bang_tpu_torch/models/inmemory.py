"""BANG_Inmemory variant: device-resident graph + PQ traversal + exact
re-rank (port of bang_tpu/models/inmemory.py).

Reference behavior (BANG_Inmemory/parANN.cu:77-906): graph and PQ codes
live on the accelerator; traversal distances come from per-query PQ
tables; after the walk every expanded node is re-ranked with exact L2
against the full-precision vectors and the top-k is returned.

On CUDA tensors a search is one launch of its captured graph
(models/compiled.py: prologue, the traversal as a WHILE node, re-rank); on
CPU tensors the eager loop runs (`search_inmemory_eager`, the captured
loop's plain version).
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
    gpu_stats,
    make_pq_distance_fn,
    rerank_topk,
    start_traversal,
)
from bang_tpu_torch.ops.adjacency import PlaneAdjacency
from bang_tpu_torch.ops.stage_clock import clock_for
from bang_tpu_torch.utils.config import SearchParams
from bang_tpu_torch.utils.timer import NO_TIMERS


def prepare_inmemory(index: DeviceIndex, queries, params: SearchParams):
    """The search's start on the index's device: (step, state, queries_f32),
    the traversal's body and initial state (traversal.start_traversal) and
    the f32 queries that `finish_inmemory` re-ranks against. Callers that
    interleave several searches (parallel/sharded.search_data_parallel)
    step them with traversal.traverse_together.

    The fetch follows the index layout, as JAX's jitted search: the fused
    rows (no adjacency table), the neighbor-aligned codes with their
    byte-plane adjacency (PlaneAdjacency), or the scattered codes with the
    int32 table; params.pq_impl picks the tables and lookups
    (traversal.make_pq_distance_fn)."""
    check_params(params)
    assert_exact_float32()
    dev = index.vectors.device
    queries_f32 = torch.as_tensor(queries, device=dev).float()
    q = queries_f32.shape[0]
    distance_fn = make_pq_distance_fn(
        queries_f32, index.codebook, index.codes, fused_rows=index.fused_rows,
        nbr_codes=index.nbr_codes, impl=params.pq_impl,
    )
    adj = index.adj
    if index.adj_planes is not None:
        adj = PlaneAdjacency(index.adj_planes)
    entry_ids, entry_dists = entry_points(index, queries_f32, params)
    step, state = start_traversal(
        adj, distance_fn, index.medoid, q, params.L, params.max_iters,
        params.beam_width, dev, entry_ids=entry_ids, entry_dists=entry_dists,
        use_bloom=params.visited_mode == "bloom",
    )
    return step, state, queries_f32


def finish_inmemory(index: DeviceIndex, queries_f32, final, params: SearchParams):
    """(ids [Q, k] int32, dists [Q, k] f32, SearchStats) from the final
    traversal state: the exact re-rank of every expanded node, or the
    worklist's head when params.rerank is off."""
    if params.rerank:
        ids, dists = rerank_topk(queries_f32, index.vectors, final.visited_ids,
                                 params.k)
    else:
        ids, dists = final.wl_ids[:, : params.k], final.wl_dist[:, : params.k]
    return ids, dists, SearchStats(final.it, final.n_expanded, final.n_dist_comps)


def search_inmemory(index: DeviceIndex, queries, params: SearchParams,
                    timers=NO_TIMERS):
    """Batched PQ-traversal search with exact re-rank on the index's device
    (prepare_inmemory, the traversal, finish_inmemory): on a CUDA index the
    captured graph of the index's graph cache (models/compiled.py; the
    first call of a search shape runs the eager loop, then captures), on a
    CPU index the eager loop.

    queries: [Q, D] tensor or numpy array. Returns (ids [Q, k] int32,
    dists [Q, k] f32 squared L2, SearchStats), on the device, with no host
    wait. With ENABLE_GPU_STATS in params.capabilities the search runs
    (and captures) its stage clock (ops/stage_clock; the SearchStats carry
    the buckets) and `timers` (utils/timer.StageTimers) takes a launch's
    spans.

    Under entry_mode="sampled" the entries and their worklist seeds come
    from exact distances to a strided sample (models/entry.py); the walk
    itself still runs on PQ distances, as in the JAX package."""
    dev = index.vectors.device
    if dev.type != "cuda":
        return search_inmemory_eager(index, queries, params)
    q = torch.as_tensor(queries)
    (ids, dists), stats = compiled.search(
        index, ("inmemory", layout_of(index), tuple(q.shape), params), q, dev,
        params.max_iters, *_parts(index, params), stats=gpu_stats(params),
        timers=timers)
    return ids, dists, stats


def _parts(index: DeviceIndex, params: SearchParams):
    """The search's start and finish, as models/compiled takes them."""
    return (lambda qs: prepare_inmemory(index, qs, params),
            lambda queries_f32, final: finish_inmemory(index, queries_f32, final,
                                                       params)[:2])


def search_inmemory_eager(index: DeviceIndex, queries, params: SearchParams):
    """search_inmemory on the eager loop (traversal.traverse, one host read
    a step), on any device: the CPU's search and the captured loop's plain
    version (compiled.run_eager, with the stage clock under
    ENABLE_GPU_STATS)."""
    (ids, dists), stats = compiled.run_eager(
        *_parts(index, params), (queries,), params.max_iters,
        clock_for(index.vectors.device, gpu_stats(params)))
    return ids, dists, stats
