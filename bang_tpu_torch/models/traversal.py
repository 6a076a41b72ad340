"""The greedy best-first graph traversal (port of bang_tpu/models/traversal.py).

The reference's hot loop (BANG_Base/bang_search.cu:701-958;
BANG_Inmemory/parANN.cu:531-611) over a batch of queries: state is a tuple
of fixed-shape [Q, ...] tensors, and each iteration runs neighbor fetch ->
visited filter -> distance -> merge -> parent select over the whole batch.
`beam` parents are expanded per iteration (beam=1 is the reference
schedule). Distances during traversal are squared L2 (no square roots, as
in the reference and DiskANN's ground truth).

The loop runs on the host and reads `active.any()` back once per
iteration, as the reference reads its `nextIter` flag (parANN.cu:595);
removing that sync (CUDA graphs over blocks of iterations) is ROADMAP
Queue 1 item 13. Two distance functions drive it: PQ table lookup
(`make_pq_distance_fn`, kernels K1 and K2) and exact L2
(`make_exact_distance_fn`, kernel K3). The bloom visited set belongs to a
later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bang_tpu_torch.constants import ENABLE_CACHE_WARMUP, ENABLE_GPU_STATS, INVALID_ID
from bang_tpu_torch.ops.exact_kernels import exact_frontier
from bang_tpu_torch.ops.l2 import l2_distance_to_candidates
from bang_tpu_torch.ops.merge import init_worklist, merge_worklist, select_parents_beam
from bang_tpu_torch.ops.pq import pack_tables, pq_distance_tables
from bang_tpu_torch.ops.pq_kernels import frontier_decode_plain, frontier_lookup, pq_lookup
from bang_tpu_torch.ops.visited import exact_new_mask, first_occurrence_mask_blocks


class TraversalState(NamedTuple):
    wl_dist: torch.Tensor  # [Q, L] f32
    wl_ids: torch.Tensor  # [Q, L] i32
    wl_vis: torch.Tensor  # [Q, L] bool
    parents: torch.Tensor  # [Q, P] i32 — selected last iteration, expanded next
    parent_valid: torch.Tensor  # [Q, P] bool
    visited_ids: torch.Tensor  # [Q, MI*P] i32 — expansion order, INVALID padding
    active: torch.Tensor  # [Q] bool
    it: int  # host-side iteration counter
    n_expanded: torch.Tensor  # int64 scalar — total parents expanded
    n_dist_comps: torch.Tensor  # int64 scalar — candidate distances computed


class SearchStats:
    """Search statistics (iterations, expanded parents, distance
    computations). The two counters stay on the device until first read;
    `sync()` fetches them."""

    __slots__ = ("iters", "_n_expanded", "_n_dist_comps")

    def __init__(self, iters: int, n_expanded, n_dist_comps):
        self.iters = int(iters)
        self._n_expanded = n_expanded
        self._n_dist_comps = n_dist_comps

    def sync(self) -> "SearchStats":
        if isinstance(self._n_expanded, torch.Tensor):
            self._n_expanded = int(self._n_expanded.item())
            self._n_dist_comps = int(self._n_dist_comps.item())
        return self

    @property
    def n_expanded(self) -> int:
        return self.sync()._n_expanded

    @property
    def n_dist_comps(self) -> int:
        return self.sync()._n_dist_comps

    def __repr__(self):
        return (f"SearchStats(iters={self.iters}, n_expanded={self.n_expanded}, "
                f"n_dist_comps={self.n_dist_comps})")


def check_params(params) -> None:
    """Raise on the SearchParams that the port's traversal does not take."""
    if params.visited_mode != "exact":
        raise NotImplementedError(
            "visited_mode='bloom' is not ported yet (ROADMAP Queue 1 item 15)"
        )
    if params.pq_impl != "auto":
        raise ValueError(
            f"pq_impl={params.pq_impl!r} names a JAX kernel; the port picks "
            "its kernel from the index layout and the tensors' device"
        )
    if params.capabilities:
        raise NotImplementedError(
            f"capabilities={params.capabilities:#x}: the port serves no capability "
            f"bit yet: ENABLE_GPU_STATS ({ENABLE_GPU_STATS:#x}) waits on the stage "
            f"timers (ROADMAP Queue 1 item 14), ENABLE_CACHE_WARMUP "
            f"({ENABLE_CACHE_WARMUP:#x}) on warmup_touch (item 11)"
        )


def init_state(q: int, l: int, max_iters: int, entries: torch.Tensor,
               entry_dists: torch.Tensor, beam: int = 1) -> TraversalState:
    """entries [Q, P<=beam] int32 seed the first P beam slots per query;
    entry_dists (same shape) are their worklist-seed distances. The seeds
    enter the worklist already visited, so paths without re-rank can still
    return them."""
    dev = entries.device
    p = entries.shape[1]
    if p > beam:
        raise ValueError(f"entry seeds {p} exceed beam width {beam}")
    wl_dist, wl_ids, wl_vis = init_worklist(q, l, dev)
    wl_dist[:, :p] = entry_dists.reshape(q, p)
    wl_ids[:, :p] = entries
    wl_vis[:, :p] = True
    parents = torch.zeros((q, beam), dtype=torch.int32, device=dev)
    parents[:, :p] = entries
    parent_valid = torch.zeros((q, beam), dtype=torch.bool, device=dev)
    parent_valid[:, :p] = True
    visited = torch.full((q, max_iters * beam), INVALID_ID, dtype=torch.int32,
                         device=dev)
    visited[:, :p] = entries
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return TraversalState(
        wl_dist, wl_ids, wl_vis, parents, parent_valid, visited,
        torch.ones((q,), dtype=torch.bool, device=dev), 1, zero, zero.clone(),
    )


def make_step(adj, distance_fn, beam: int = 1):
    """Build the per-iteration body.

    `distance_fn(cand_ids [Q, C], parents [Q, P]) -> [Q, C] f32`. When
    `distance_fn.frontier_fn(parents) -> (cand_ids, dists)` exists (fused
    rows), one call yields both and `adj` is not read: pass None.
    `adj`: [N, R] int32 tensor (scattered layout) or None."""
    frontier_fn = getattr(distance_fn, "frontier_fn", None)
    if adj is not None:
        r = adj.shape[1]
    elif frontier_fn is not None:
        r = distance_fn.r
    else:
        raise ValueError("need an adjacency table or a distance_fn.frontier_fn")

    def step(state: TraversalState) -> TraversalState:
        q = state.parents.shape[0]
        if frontier_fn is not None:
            cand, raw = frontier_fn(state.parents)
        else:
            cand = adj[state.parents.long()].reshape(q, beam * r)
            raw = None
        cand_valid = state.parent_valid.repeat_interleave(r, dim=1)

        new = exact_new_mask(cand, state.wl_ids, state.visited_ids)
        new = new & cand_valid & state.active[:, None]
        if beam > 1:
            # parents expanded together may share neighbors — keep first lane
            new = new & first_occurrence_mask_blocks(cand, beam)
        if raw is None:
            raw = distance_fn(cand, state.parents)
        dist = torch.where(new, raw, torch.full_like(raw, float("inf")))
        wl_dist, wl_ids, wl_vis = merge_worklist(
            state.wl_dist, state.wl_ids, state.wl_vis, dist, cand
        )
        parents, parent_valid, active, wl_vis = select_parents_beam(
            wl_dist, wl_ids, wl_vis, beam
        )
        # in place: the previous state's visited list is not read again
        visited = state.visited_ids
        visited[:, state.it * beam : (state.it + 1) * beam] = torch.where(
            parent_valid, parents, torch.full_like(parents, INVALID_ID)
        )
        return TraversalState(
            wl_dist, wl_ids, wl_vis, parents, parent_valid, visited, active,
            state.it + 1,
            state.n_expanded + state.parent_valid.sum(),
            state.n_dist_comps + new.sum(),
        )

    return step


def run_traversal(adj, distance_fn, medoid: int, q: int, l: int,
                  max_iters: int, beam: int, device, entry_ids=None,
                  entry_dists=None) -> TraversalState:
    """Run the traversal; returns the final state. Stops after `max_iters`
    iterations or when no query has an unvisited worklist entry left.

    By default every query enters at the shared `medoid`. entry_ids [Q] or
    [Q, P<=beam] int32 (sampled-entry mode, models/entry.py) give per-query
    entries instead, [Q, P] seeding P beam slots; entry_dists (same shape)
    are their worklist-seed distances and are required with them."""
    step = make_step(adj, distance_fn, beam)
    if entry_ids is None:
        entry = torch.full((q, 1), medoid, dtype=torch.int32, device=device)
        # the entry's distance: distance_fn's seed_fn when it has one (all
        # queries share this one node, so no gather and no kernel is needed)
        seed_fn = getattr(distance_fn, "seed_fn", distance_fn)
        entry_dists = seed_fn(entry, None)
    else:
        if entry_dists is None:
            raise ValueError("entry_ids requires entry_dists")
        entry = (entry_ids if entry_ids.ndim == 2 else entry_ids[:, None]).to(torch.int32)
    state = init_state(q, l, max_iters, entry, entry_dists, beam)
    while state.it < max_iters and bool(state.active.any()):
        state = step(state)
    return state


def make_exact_distance_fn(queries_f32, vectors, nbr_vecs=None,
                           nbr_vec_norms=None, fused_vec_rows=None):
    """Traversal distance: exact squared L2 against device-resident vectors
    (BANG_Exactdistance behavior, parANN.cu:1139-1179). Three fetches:

      scattered        `distance_fn(cand_ids, parents)` gathers each
                       candidate's vector and recomputes its norm (one
                       gather, exact in f32 for u8 data).
      nbr_vecs         with nbr_vecs [N, R, D] and nbr_vec_norms [N, R], the
                       candidates' vectors and norms are gathered per parent
                       as two contiguous rows.
      fused exact rows with fused_vec_rows [N, R*(8+D)] u8 (ops/l2.
                       pack_exact_frontier_rows) it also carries
                       `frontier_fn(parents)`, which runs K3
                       (`exact_frontier`) on the ungathered rows and yields
                       ids and distances at once, and the degree `r`.

    There is no `seed_fn`: the shared entry's distance is distance_fn(entry,
    None), the scattered fetch. The JAX function's `vector_norms` argument
    is not taken: no fetch reads it."""
    d = queries_f32.shape[-1]

    def distance_fn(cand_ids, parents=None):
        if nbr_vecs is not None and parents is not None:
            q = cand_ids.shape[0]
            p = parents.long()
            vecs = nbr_vecs[p].reshape(q, -1, d)
            norms = nbr_vec_norms[p].reshape(q, -1)
        else:
            vecs = vectors[cand_ids.long()]  # [Q, C, D] gather
            norms = None
        return l2_distance_to_candidates(queries_f32, vecs, norms)

    if fused_vec_rows is not None:
        distance_fn.r = fused_vec_rows.shape[1] // (8 + d)

        def frontier_fn(parents):
            return exact_frontier(queries_f32, fused_vec_rows, parents)

        distance_fn.frontier_fn = frontier_fn
    return distance_fn


def make_pq_distance_fn(queries_f32, codebook, codes, fused_rows=None):
    """Traversal distance: PQ table lookup (BANG_Base/Inmemory behavior).
    Tables are built once per batch.

    Without fused rows, `distance_fn(cand_ids, parents)` gathers each
    candidate's codes and runs K1 (`pq_lookup`) on f32 tables (K1's packed
    form, K4, is not on a search path yet). With fused_rows [N, R*(4+m)] u8
    it carries `frontier_fn(parents)` instead, which yields ids and
    distances from the ungathered rows, and the degree `r`. The device
    picks the fused route, as the JAX package's `impl="auto"` does: on a
    CUDA device the tables are packed once per batch (`pack_tables`, bf16
    pairs) and K2 (`frontier_lookup`) reads them, the f32 tables dropped; on
    the CPU `frontier_decode_plain` reads the f32 tables (JAX's
    `frontier_decode_xla`, what the JAX package runs there). `seed_fn` gives
    the shared entry node's distance directly from its reconstructed
    vector."""
    m = codebook.num_chunks
    tables = pq_distance_tables(codebook, queries_f32)
    if fused_rows is not None and queries_f32.device.type == "cuda":
        packed = pack_tables(tables)
        del tables  # nothing on this route reads the f32 tables

        def distance_fn(cand_ids, parents=None):
            raise RuntimeError("the fused route yields distances through frontier_fn")

        def frontier_fn(parents):
            return frontier_lookup(packed, fused_rows, parents)
    else:

        def distance_fn(cand_ids, parents=None):
            return pq_lookup(tables, codes[cand_ids.long()])  # [Q, C, m] gather

        def frontier_fn(parents):
            return frontier_decode_plain(tables, fused_rows, parents)

    def seed_fn(cand_ids, parents=None):
        node_codes = codes[cand_ids[0, 0].long()].long()  # same node for all
        recon = codebook.piv_chunks[
            torch.arange(m, device=codes.device), node_codes
        ]  # [m, dmax]
        qc = (queries_f32 - codebook.centroid)[:, codebook.dim_idx]
        qc = qc * codebook.dim_mask  # [Q, m, dmax]
        return ((qc - recon[None]) ** 2).sum(dim=(1, 2))[:, None]

    distance_fn.seed_fn = seed_fn
    if fused_rows is not None:
        distance_fn.r = fused_rows.shape[1] // (4 + m)
        distance_fn.frontier_fn = frontier_fn
    return distance_fn


def rerank_topk(queries_f32: torch.Tensor, vectors: torch.Tensor,
                visited_ids: torch.Tensor, k: int):
    """Exact re-rank of all expanded nodes, then top-k.

    Replaces the reference's compute_L2Dist + compute_NearestNeighbours pair
    (bang_search.cu:1254-1368). Ties break lowest index first, as
    `lax.top_k` does in the JAX package: a stable ascending sort, not
    `torch.topk`, whose tie order is unspecified (u8 data gives integer
    distances and frequent ties). Returns (ids [Q, k] i32, dists [Q, k] f32
    squared L2)."""
    safe_ids = visited_ids.clamp_min(0).long()
    vecs = vectors[safe_ids]  # [Q, MI, D]
    d = l2_distance_to_candidates(queries_f32, vecs)
    d = torch.where(visited_ids == INVALID_ID, torch.full_like(d, float("inf")), d)
    sd, order = torch.sort(d, dim=1, stable=True)
    return visited_ids.gather(1, order[:, :k]), sd[:, :k]
