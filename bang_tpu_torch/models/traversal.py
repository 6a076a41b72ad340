"""The greedy best-first graph traversal (port of bang_tpu/models/traversal.py).

The reference's hot loop (BANG_Base/bang_search.cu:701-958;
BANG_Inmemory/parANN.cu:531-611) over a batch of queries: state is a tuple
of fixed-shape [Q, ...] tensors, and each iteration runs neighbor fetch ->
visited filter -> distance -> merge -> parent select over the whole batch.
`beam` parents are expanded per iteration (beam=1 is the reference
schedule). Distances during traversal are squared L2 (no square roots, as
in the reference and DiskANN's ground truth).

The iteration counter `it` is an int32 scalar on the device, as in JAX,
and the loop's condition is JAX's `lax.while_loop` condition,
`(it < max_iters) & active.any()` (`go_flag`). Two loops run the same
step. On CUDA tensors the search is one CUDA graph whose WHILE node
evaluates that condition on the device (models/compiled.py) and runs its
body, `step_`, the step written into the state's own buffers, only while
the condition holds. The Vamana insert and the streaming
index run the same captured loop over static input buffers (formats/
vamana.py, models/streaming.py). On CPU tensors, and at a key's first
call on the card, `traverse` is the loop's plain version: the host counts
the iterations and reads `active.any()` once per iteration, as the
reference reads its `nextIter` flag (parANN.cu:595). Independent walks (the shards of parallel/sharded.py on
the CPU) step together in rounds, with one read of their stacked flags a
round (`traverse_together`). Two distance functions drive it: PQ table lookup
(`make_pq_distance_fn`, kernels K1 and K2) and exact L2
(`make_exact_distance_fn`, kernel K3). Two visited sets filter the
candidates: the exact mask, with the beam's first-occurrence mask and the
+inf masking in one kernel a step on the card (ops/visited.visited_filter,
the default), or the reference's per-query bloom filter (ops/bloom.py,
`visited_mode="bloom"`), inserted after the beam's first-occurrence mask,
in the JAX package's order. The bloom filter also blocks the re-entry of
nodes evicted before they were expanded, which the exact mask allows; the
JAX package differs the same way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bang_tpu_torch.constants import ENABLE_CACHE_WARMUP, ENABLE_GPU_STATS, INVALID_ID
from bang_tpu_torch.ops.bloom import bloom_insert, bloom_positions, bloom_query, new_bloom
from bang_tpu_torch.ops.exact_kernels import exact_frontier
from bang_tpu_torch.ops.l2 import l2_distance_to_candidates
from bang_tpu_torch.ops.merge import init_worklist, merge_worklist, select_parents_beam
from bang_tpu_torch.ops.pq import pack_tables, pq_distance_tables
from bang_tpu_torch.ops.pq import pq_lookup as pq_lookup_f32
from bang_tpu_torch.ops.pq_kernels import frontier_decode_plain, frontier_lookup, pq_lookup
from bang_tpu_torch.ops.stage_clock import NO_CLOCK, STAGES
from bang_tpu_torch.ops.visited import first_occurrence_mask_blocks, visited_filter


class TraversalState(NamedTuple):
    wl_dist: torch.Tensor  # [Q, L] f32
    wl_ids: torch.Tensor  # [Q, L] i32
    wl_vis: torch.Tensor  # [Q, L] bool
    parents: torch.Tensor  # [Q, P] i32 — selected last iteration, expanded next
    parent_valid: torch.Tensor  # [Q, P] bool
    visited_ids: torch.Tensor  # [Q, MI*P] i32 — expansion order, INVALID padding
    bloom: Optional[torch.Tensor]  # [Q, BF + 1] u8 (ops/bloom.py) or None (exact)
    active: torch.Tensor  # [Q] bool
    it: torch.Tensor  # int32 scalar on the device: iterations so far, from 1
    n_expanded: torch.Tensor  # int64 scalar — total parents expanded
    n_dist_comps: torch.Tensor  # int64 scalar — candidate distances computed


class SearchStats:
    """Search statistics (iterations, expanded parents, distance
    computations). The counters stay on the device until first read;
    `sync()` fetches all three in one copy, so a search call does not
    block. Under ENABLE_GPU_STATS a search also gives `stages`, its stage
    clock's buckets (ops/stage_clock.STAGES, ns, on the device), read in
    the same copy, and `host_reads`, the reads of its loop flag that the
    eager loop made (a captured loop makes none)."""

    __slots__ = ("_values", "_fetched", "_stages", "host_reads")

    def __init__(self, iters, n_expanded, n_dist_comps, stages=None, host_reads=0):
        self._values = (iters, n_expanded, n_dist_comps)
        self._stages = stages
        self.host_reads = host_reads
        self._fetched = not any(isinstance(v, torch.Tensor)
                                for v in (*self._values, stages))

    def device_values(self) -> torch.Tensor:
        """The three counters as one int64 [3] tensor on their device, the
        stage buckets after them when there are any."""
        values = torch.stack([torch.as_tensor(v).long() for v in self._values])
        if self._stages is None:
            return values
        return torch.cat([values, torch.as_tensor(self._stages)])

    def sync(self, values=None) -> "SearchStats":
        """Fetch the counters, or take `values`, the host copy of
        device_values() a caller read with its results."""
        if not self._fetched:
            if values is None:
                values = self.device_values().tolist()
            self._values = tuple(int(v) for v in values[:3])
            if self._stages is not None:
                self._stages = [int(v) for v in values[3:]]
            self._fetched = True
        return self

    @property
    def iters(self) -> int:
        return self.sync()._values[0]

    @property
    def n_expanded(self) -> int:
        return self.sync()._values[1]

    @property
    def n_dist_comps(self) -> int:
        return self.sync()._values[2]

    @property
    def stage_ms(self):
        """{stage: device ms} of the search's stage clock, None without
        one."""
        if self.sync()._stages is None:
            return None
        return {name: ns / 1e6 for name, ns in zip(STAGES, self._stages)}

    def __repr__(self):
        return (f"SearchStats(iters={self.iters}, n_expanded={self.n_expanded}, "
                f"n_dist_comps={self.n_dist_comps})")


def check_params(params) -> None:
    """Raise on the SearchParams that the port's traversal does not take.
    Both visited modes and the four pq_impl values are served
    (SearchParams checks their names; make_pq_distance_fn maps pq_impl)."""
    # both bits are served (api.BANGSearch): ENABLE_GPU_STATS turns base's
    # stage timers on and gives the HBM variants their stage report;
    # ENABLE_CACHE_WARMUP runs utils/graph_tools.warmup_touch in bang_alloc
    served = ENABLE_GPU_STATS | ENABLE_CACHE_WARMUP
    if params.capabilities & ~served:
        raise ValueError(
            f"capabilities={params.capabilities:#x}: the known bits are "
            f"ENABLE_GPU_STATS ({ENABLE_GPU_STATS:#x}) and ENABLE_CACHE_WARMUP "
            f"({ENABLE_CACHE_WARMUP:#x})"
        )


def gpu_stats(params) -> bool:
    """Whether params ask for the stage report (ENABLE_GPU_STATS)."""
    return bool(params.capabilities & ENABLE_GPU_STATS)


def init_state(q: int, l: int, max_iters: int, entries: torch.Tensor,
               entry_dists: torch.Tensor, beam: int = 1,
               use_bloom: bool = False) -> TraversalState:
    """entries [Q, P<=beam] int32 seed the first P beam slots per query;
    entry_dists (same shape) are their worklist-seed distances. The seeds
    enter the worklist already visited, so paths without re-rank can still
    return them. use_bloom: a bloom filter holding the seeds."""
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
    bloom = None
    if use_bloom:
        bloom = bloom_insert(new_bloom(q, dev), entries,
                             torch.ones((q, p), dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return TraversalState(
        wl_dist, wl_ids, wl_vis, parents, parent_valid, visited, bloom,
        torch.ones((q,), dtype=torch.bool, device=dev),
        torch.ones((), dtype=torch.int32, device=dev), zero, zero.clone(),
    )


def slot_index(it: torch.Tensor, beam: int):
    """The `beam` visited-list slots of iteration `it` (a device scalar),
    it*beam ... it*beam + beam - 1, as an int64 index on its device. Both
    loops step only while it < max_iters, so the slots stay in range."""
    return it.long() * beam + torch.arange(beam, device=it.device)


def go_flag(state, max_iters: int, out=None) -> torch.Tensor:
    """The loop's condition on the device, JAX's while_loop condition:
    (it < max_iters) & active.any(), a bool scalar (written into `out` when
    given)."""
    return torch.logical_and(state.it < max_iters, state.active.any(), out=out)


def make_step(adj, distance_fn, beam: int = 1, use_bloom: bool = False):
    """Build the per-iteration body, `step(state) -> new state`.

    `distance_fn(cand_ids [Q, C], parents [Q, P]) -> [Q, C] f32`. When
    `distance_fn.frontier_fn(parents) -> (cand_ids, dists)` exists (fused
    rows), one call yields both and `adj` is not read: pass None.
    `adj`: an [N, R] int32 tensor (scattered layout), a callable
    `parents [Q, P] -> ids [Q, P*R]` with `.r` (ops/adjacency.
    PlaneAdjacency, the neighbor-aligned layout's byte planes) or None.
    use_bloom: the visited set is the state's bloom filter, not the exact
    mask.

    The visited list and the bloom filter are written in place (the old
    state does not read them again); the rest of the new state is new
    tensors, which `step_` writes into the old state's buffers.

    `step(state, clock)` stamps a stage clock (ops/stage_clock.StageClock
    under ENABLE_GPU_STATS, else NO_CLOCK, whose stamps do nothing):
    `carry` first (what ran since the last step's `select`), then
    `frontier`, `visited`, `merge` and `select` after each of its stages:
    five stamps a step."""
    frontier_fn = getattr(distance_fn, "frontier_fn", None)
    if callable(adj):
        r = adj.r
        fetch_adj = adj
    elif adj is not None:
        r = adj.shape[1]

        def fetch_adj(parents):
            return adj[parents.long()].reshape(parents.shape[0], beam * r)
    elif frontier_fn is not None:
        r = distance_fn.r
    else:
        raise ValueError("need an adjacency table or a distance_fn.frontier_fn")

    def step(state: TraversalState, clock=NO_CLOCK) -> TraversalState:
        clock.stamp("carry")
        q = state.parents.shape[0]
        if frontier_fn is not None:
            cand, raw = frontier_fn(state.parents)
        else:
            cand = fetch_adj(state.parents)  # [Q, beam*R]
            # the distances read neither visited set: computed before them
            raw = distance_fn(cand, state.parents)
        clock.stamp("frontier")
        if use_bloom:
            # repeat_interleave with an int count reads its output size back
            cand_valid = state.parent_valid[:, :, None].expand(q, beam, r).reshape(
                q, beam * r)
            pos = bloom_positions(cand, state.bloom.shape[1] - 1)  # query + insert
            new = ~bloom_query(state.bloom, cand, pos) & cand_valid & state.active[:, None]
            if beam > 1:
                # parents expanded together may share neighbors — keep first lane
                new = new & first_occurrence_mask_blocks(cand, beam)
            bloom_insert(state.bloom, cand, new, pos)
            dist = torch.where(new, raw, torch.full_like(raw, float("inf")))
        else:
            # the eager loop's `active` is a column of select_parents_beam's
            # valid; the captured loop's is its own contiguous buffer
            new, dist = visited_filter(cand, raw, state.wl_ids, state.visited_ids,
                                       state.parent_valid, state.active.contiguous(),
                                       beam)
        clock.stamp("visited")
        wl_dist, wl_ids, wl_vis = merge_worklist(
            state.wl_dist, state.wl_ids, state.wl_vis, dist, cand
        )
        clock.stamp("merge")
        parents, parent_valid, active, wl_vis = select_parents_beam(
            wl_dist, wl_ids, wl_vis, beam
        )
        visited = state.visited_ids
        vals = torch.where(parent_valid, parents, torch.full_like(parents, INVALID_ID))
        visited.index_copy_(1, slot_index(state.it, beam), vals)
        clock.stamp("select")
        return TraversalState(
            wl_dist, wl_ids, wl_vis, parents, parent_valid, visited, state.bloom,
            active, state.it + 1,
            state.n_expanded + state.parent_valid.sum(),
            state.n_dist_comps + new.sum(),
        )

    return step


def step_(step, state: TraversalState, clock=NO_CLOCK) -> TraversalState:
    """One iteration written into `state`'s own buffers: the body of the
    captured loop (models/compiled.py), replayed on the same buffers, as
    JAX's while_loop reuses its donated carry. Its WHILE node runs it only
    while go_flag holds, as JAX's loop runs its body. `clock`: the stage
    clock the step stamps (make_step). Returns `state`."""
    new = step(state, clock)
    for old, value in zip(state, new):
        if value is not old:  # the visited list and the bloom filter are
            old.copy_(value)  # written in place already
    return state


def start_traversal(adj, distance_fn, medoid: int, q: int, l: int,
                    max_iters: int, beam: int, device, entry_ids=None,
                    entry_dists=None, use_bloom: bool = False):
    """The traversal's start: (step, state), the per-iteration body
    (make_step) and the initial state, for `traverse` or
    `traverse_together`. use_bloom: filter with the bloom visited set
    (ops/bloom.py).

    By default every query enters at the shared `medoid`: a host int, or an
    integer scalar tensor on `device`, read as data (no host read), as JAX
    passes its medoid; a captured loop takes it as a static input, so a
    new medoid needs no new capture. entry_ids [Q] or [Q, P<=beam] int32
    (sampled-entry mode, models/entry.py) give per-query entries instead,
    [Q, P] seeding P beam slots; entry_dists (same shape) are their
    worklist-seed distances and are required with them."""
    step = make_step(adj, distance_fn, beam, use_bloom)
    if entry_ids is None:
        if isinstance(medoid, torch.Tensor):
            entry = medoid.to(torch.int32).reshape(1, 1).expand(q, 1)
        else:
            entry = torch.full((q, 1), medoid, dtype=torch.int32, device=device)
        # the entry's distance: distance_fn's seed_fn when it has one (all
        # queries share this one node, so no gather and no kernel is needed)
        seed_fn = getattr(distance_fn, "seed_fn", distance_fn)
        entry_dists = seed_fn(entry, None)
    else:
        if entry_dists is None:
            raise ValueError("entry_ids requires entry_dists")
        entry = (entry_ids if entry_ids.ndim == 2 else entry_ids[:, None]).to(torch.int32)
    return step, init_state(q, l, max_iters, entry, entry_dists, beam, use_bloom)


def traverse(step, state: TraversalState, max_iters: int,
             clock=NO_CLOCK) -> TraversalState:
    """Step until `max_iters` iterations or until no query has an unvisited
    worklist entry left; returns the final state. The captured loop's plain
    version: the host counts the iterations (the device's `it` starts at 1
    and gains one a step) and reads `active.any()` once per iteration.
    `clock`: the stage clock the steps stamp (make_step), which also counts
    those reads (`clock.reads`)."""
    it = 1
    while it < max_iters and clock.read(state.active.any()):
        state = step(state, clock)
        it += 1
    return state


def _still_live(states, its, idx, max_iters: int, home) -> list:
    """The walks of `idx` that step again: those under `max_iters` (their
    host counts `its`) whose `active.any()` holds, read for all of them at
    once (their flags stacked on `home`, one host read)."""
    idx = [i for i in idx if its[i] < max_iters]
    if not idx:
        return []
    flags = torch.stack([states[i].active.any().to(home) for i in idx]).tolist()
    return [i for i, live in zip(idx, flags) if live]


def traverse_together(walks, max_iters: int, home) -> list:
    """`traverse` for several independent walks (`(step, state)` pairs, on
    one device or several), stepped in rounds: each round steps every walk
    that is still live, then one host read of their stacked flags on `home`
    decides which step again, where `traverse` would read each walk's flag
    on its own. A walk that has finished is never stepped again, so every
    walk takes exactly the iterations, and ends in exactly the state, that
    `traverse` gives it. Returns the final states in the walks' order."""
    states = [state for _, state in walks]
    its = [1] * len(walks)
    live = _still_live(states, its, range(len(walks)), max_iters, home)
    while live:
        for i in live:
            states[i] = walks[i][0](states[i])
            its[i] += 1
        live = _still_live(states, its, live, max_iters, home)
    return states


def run_traversal(adj, distance_fn, medoid: int, q: int, l: int,
                  max_iters: int, beam: int, device, entry_ids=None,
                  entry_dists=None, use_bloom: bool = False) -> TraversalState:
    """Run the traversal (start_traversal, then traverse); returns the final
    state. Stops after `max_iters` iterations or when no query has an
    unvisited worklist entry left."""
    step, state = start_traversal(adj, distance_fn, medoid, q, l, max_iters, beam,
                                  device, entry_ids, entry_dists, use_bloom)
    return traverse(step, state, max_iters)


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


PQ_IMPLS = ("auto", "pallas", "pallas_dma", "xla")


def packs_tables(pq_impl: str, device) -> bool:
    """Whether the PQ lookups of `pq_impl` on `device` read bf16-pair
    tables (`pack_tables`; K1 and K2 on the card, their plain versions on
    the CPU) rather than f32 tables: "auto" on a CUDA device, "pallas" and
    "pallas_dma" anywhere, "xla" never."""
    if pq_impl not in PQ_IMPLS:
        raise ValueError(f"unknown pq_impl {pq_impl!r}")
    if pq_impl == "auto":
        return torch.device(device).type == "cuda"
    return pq_impl != "xla"


def make_pq_distance_fn(queries_f32, codebook, codes, fused_rows=None,
                        nbr_codes=None, impl: str = "auto"):
    """Traversal distance: PQ table lookup (BANG_Base/Inmemory behavior).
    Tables are built once per batch.

    `distance_fn(cand_ids, parents)` fetches each candidate's codes and
    sums their table entries. The fetch follows the layout, as the JAX
    package's `fetch_codes`: with nbr_codes [N, R*m] u8 (the
    neighbor-aligned layout) one row a parent, `nbr_codes[parents]` viewed
    as [Q, P*R, m]; else, and for the entry seed, which has no parents,
    the scattered `codes[cand_ids]`. With fused_rows [N, R*(4+m)] u8 it
    also carries `frontier_fn(parents)`, which yields ids and distances
    from the ungathered rows, and the degree `r`.

    impl is SearchParams.pq_impl, mapped onto the port's routes:
      "auto"        the device picks, as JAX's "auto" does: on a CUDA
                    device the tables are packed once per batch
                    (`pack_tables`, bf16 pairs) and K1 (`pq_lookup`) reads
                    them for fetched codes, K2 (`frontier_lookup`) for the
                    fused rows, the two summing the same entries in the
                    same order; on the CPU the f32 tables, ops/pq.pq_lookup
                    and `frontier_decode_plain` (JAX's `frontier_decode_xla`).
      "pallas"      the packed tables on any device: the kernels on the
                    card, their plain versions on the CPU (what JAX's
                    interpret mode computes). JAX decodes R=32 rows outside
                    its lane-rotation kernel's envelope in XLA; K2 takes
                    every R.
      "pallas_dma"  "pallas" with K2 on the fused rows, which it reads in
                    place (JAX's in-kernel DMA frontier); an index without
                    fused rows raises, with JAX's message.
      "xla"         the f32 tables and the plain lookups on either device:
                    an explicit request, never a fallback.
    `seed_fn` gives the shared entry node's distance directly from its
    reconstructed vector."""
    if impl == "pallas_dma" and fused_rows is None:
        raise ValueError(
            "pq_impl='pallas_dma' requires fused frontier rows "
            "(pack_frontier_rows_tiled); this index has none — "
            "use pq_impl='pallas' or build with fused_frontier=True"
        )
    m = codebook.num_chunks
    tables = pq_distance_tables(codebook, queries_f32)
    if packs_tables(impl, queries_f32.device):
        tables = pack_tables(tables)  # the f32 tables are not read again
        lookup, frontier = pq_lookup, frontier_lookup
    else:
        lookup, frontier = pq_lookup_f32, frontier_decode_plain

    def fetch_codes(cand_ids, parents):
        if nbr_codes is not None and parents is not None:
            q = cand_ids.shape[0]
            return nbr_codes[parents.long()].reshape(q, -1, m)  # one row a parent
        return codes[cand_ids.long()]  # [Q, C, m] scattered gather

    def distance_fn(cand_ids, parents=None):
        return lookup(tables, fetch_codes(cand_ids, parents))

    def seed_fn(cand_ids, parents=None):
        # same node for all; a [1] index, not a 0-d one, which reads back
        node_codes = codes[cand_ids[0, :1].long()][0].long()
        recon = codebook.piv_chunks[
            torch.arange(m, device=node_codes.device), node_codes
        ]  # [m, dmax]
        qc = (queries_f32 - codebook.centroid)[:, codebook.dim_idx]
        qc = qc * codebook.dim_mask  # [Q, m, dmax]
        return ((qc - recon[None]) ** 2).sum(dim=(1, 2))[:, None]

    distance_fn.seed_fn = seed_fn
    if fused_rows is not None:
        distance_fn.r = fused_rows.shape[1] // (4 + m)

        def frontier_fn(parents):
            return frontier(tables, fused_rows, parents)

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
