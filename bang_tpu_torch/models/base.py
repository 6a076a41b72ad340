"""BANG_Base variant: billion-scale search with the graph in host RAM (port of
bang_tpu/models/base.py).

Reference behavior (BANG_Base/bang_search.cu:569-1068): the PQ codes live on
the card; the packed graph (vectors + adjacency) stays in host RAM, because
at billion scale it does not fit in device memory. Each iteration the host
fetches the current parents' adjacency rows and full-precision vectors with
a multithreaded gather (native/host_gather.cpp) and ships them to the
device, which filters, computes PQ distances (K1 `pq_lookup` over the
gathered codes, ops/pq_kernels.py), merges the worklist and returns the next
parents. As in the JAX package, the exact distance of each parent is
computed the moment its vector arrives and only that scalar is kept, so the
final top-k needs no second gather.

The pipeline: the query batch is split into sub-batches, each with its own
CUDA stream, its own pinned staging and readback buffers and an event.
While the card steps some sub-batches, the host gathers for the next one.
The reference gets the same overlap from 4 CUDA streams and a speculative
parent prefetch (bang_search.cu:1384-1521), the JAX package from
asynchronous dispatch and a stacked `device_get`. On the CPU the same loop
runs synchronously, with no streams and no events.

On the card each sub-batch's prologue (tables, entries, initial state) and
step (K1 on codes[nbrs], then `_step_core`, written into the state's own
buffers) are CUDA graphs, captured on the sub-batch's stream into its own
memory pool (the sub-batches replay at once on their streams), as JAX
compiles its `_base_step` once and donates its state. A step is then two
host-to-device copies of the pinned staging into static device buffers
(`nbrs`, `vecs`), one replay and two readback copies, where the eager step
issued about 60 operations. The outer loop stays on the host, as in JAX:
the host gather sits between steps. The first search of a key (the query
split and SearchParams) runs the eager step, then captures; the searcher
holds one key's graphs at a time. The chunk-sharded subclass
(parallel/base_tp.py), whose shards may sit on several devices, stays
eager.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from bang_tpu_torch.constants import INVALID_ID
from bang_tpu_torch.device import assert_exact_float32, resolve_device
from bang_tpu_torch.formats.graph import (
    GRAPH_INDEX_FILE_SUFFIX,
    GRAPH_METADATA_FILE_SUFFIX,
    load_metadata,
)
from bang_tpu_torch.formats.pq import load_pq
from bang_tpu_torch.models import compiled
from bang_tpu_torch.models.traversal import check_params, make_pq_distance_fn, slot_index
from bang_tpu_torch.native import gather_parents
from bang_tpu_torch.ops.bloom import bloom_insert, bloom_positions, bloom_query, new_bloom
from bang_tpu_torch.ops.merge import init_worklist, merge_worklist, select_parents_beam
from bang_tpu_torch.ops.pq import prepare_pq_codebook
from bang_tpu_torch.ops.visited import exact_new_mask, first_occurrence_mask_blocks
from bang_tpu_torch.utils.config import SearchParams
from bang_tpu_torch.utils.timer import StageTimers

# the metadata's dtype codes (constants.DTYPE_CODE_TO_NUMPY) as torch dtypes
_TORCH_DTYPE = {0: torch.int8, 1: torch.uint8, 2: torch.float32}


class BaseState(NamedTuple):
    wl_dist: torch.Tensor  # [Q, L] f32
    wl_ids: torch.Tensor  # [Q, L] i32
    wl_vis: torch.Tensor  # [Q, L] bool
    parent_valid: torch.Tensor  # [Q, P] bool
    visited_ids: torch.Tensor  # [Q, MI*P] i32
    l2_dists: torch.Tensor  # [Q, MI*P] f32 exact distances of expanded nodes
    bloom: Optional[torch.Tensor]  # [Q, BF + 1] u8 (ops/bloom.py) or None (exact)
    active: torch.Tensor  # [Q] bool
    it: torch.Tensor  # int32 scalar on the device: iterations so far, from 1


def _init_state(q: int, l: int, max_iters: int, entries: torch.Tensor,
                beam: int = 1, use_bloom: bool = False) -> BaseState:
    """entries [Q, P<=beam] int32 seed the first P beam slots per query. The
    worklist starts empty (unlike traversal.init_state): the first step
    computes each entry's exact distance when its vector arrives from the
    host, and its neighbors fill the worklist. use_bloom: a bloom filter
    holding the seeds (then every step filters with it)."""
    dev = entries.device
    p = entries.shape[1]
    if p > beam:
        raise ValueError(f"entry seeds {p} exceed beam width {beam}")
    wl_dist, wl_ids, wl_vis = init_worklist(q, l, dev)
    parent_valid = torch.zeros((q, beam), dtype=torch.bool, device=dev)
    parent_valid[:, :p] = True
    visited = torch.full((q, max_iters * beam), INVALID_ID, dtype=torch.int32,
                         device=dev)
    visited[:, :p] = entries
    l2d = torch.full((q, max_iters * beam), float("inf"), dtype=torch.float32,
                     device=dev)
    bloom = None
    if use_bloom:
        bloom = bloom_insert(new_bloom(q, dev), entries,
                             torch.ones((q, p), dtype=torch.bool, device=dev))
    return BaseState(wl_dist, wl_ids, wl_vis, parent_valid, visited, l2d, bloom,
                     torch.ones((q,), dtype=torch.bool, device=dev),
                     torch.ones((), dtype=torch.int32, device=dev))


def _step_core(state: BaseState, nbrs, parent_vecs, queries_f32, raw, beam):
    """One device iteration given the host-gathered neighbors nbrs [Q, P*R]
    int32, the parents' vectors parent_vecs [Q, P, D] in the index's storage
    dtype, and the candidates' PQ distances raw [Q, P*R] f32. Returns (new
    state, parents [Q, P] int32, active.any()). The visited and exact
    distance slots, and the bloom filter when the state has one, are written
    in place (the old state is not read again), at slots indexed by the
    device's `it`: the host loop steps only while it < max_iters."""
    q, c = nbrs.shape
    # exact distances of the parents expanded now (their visited slots are
    # (it-1)*P ...): the cast is exact for integer data, a no-op for f32
    pd = ((parent_vecs.float() - queries_f32[:, None, :]) ** 2).sum(-1)  # [Q, P]
    l2d = state.l2_dists
    l2d.index_copy_(1, slot_index(state.it - 1, beam), pd.masked_fill(
        ~(state.parent_valid & state.active[:, None]), float("inf")))
    # repeat_interleave with an int count reads its output size back
    cand_valid = state.parent_valid[:, :, None].expand(q, beam, c // beam).reshape(q, c)

    use_bloom = state.bloom is not None
    if use_bloom:
        pos = bloom_positions(nbrs, state.bloom.shape[1] - 1)  # query + insert
        new = ~bloom_query(state.bloom, nbrs, pos)
    else:
        new = exact_new_mask(nbrs, state.wl_ids, state.visited_ids)
    new = new & cand_valid & state.active[:, None]
    if beam > 1:
        new = new & first_occurrence_mask_blocks(nbrs, beam)
    if use_bloom:
        bloom_insert(state.bloom, nbrs, new, pos)
    dist = raw.masked_fill(~new, float("inf"))
    wl_dist, wl_ids, wl_vis = merge_worklist(
        state.wl_dist, state.wl_ids, state.wl_vis, dist, nbrs
    )
    parents, parent_valid, active, wl_vis = select_parents_beam(
        wl_dist, wl_ids, wl_vis, beam
    )
    visited = state.visited_ids
    visited.index_copy_(1, slot_index(state.it, beam),
                        parents.masked_fill(~parent_valid, INVALID_ID))
    new_state = BaseState(wl_dist, wl_ids, wl_vis, parent_valid, visited, l2d,
                          state.bloom, active, state.it + 1)
    return new_state, parents, active.any()


def _sampled_entry_base(queries_f32, codes, codebook, n_samples: int, b: int):
    """Per-query top-B entries for the Base variant, [Q, B] int32.

    No full-precision vectors live on the device here, so the strided
    sample's vectors are reconstructed from their PQ codes and ranked by
    exact distance in the quantized space: one [Q, m*dmax] x [m*dmax, S]
    product. Ties break lowest sample index first, as `lax.top_k` does: an
    argmin for B=1, else a stable ascending sort."""
    n = codes.shape[0]
    s = int(min(n_samples, n))
    stride = max(1, n // s)
    ids = (torch.arange(s, device=codes.device) * stride) % n
    m = codebook.num_chunks
    recon = codebook.piv_chunks[
        torch.arange(m, device=codes.device)[None, :], codes[ids].long()
    ]  # [S, m, dmax]
    qc = (queries_f32 - codebook.centroid)[:, codebook.dim_idx] * codebook.dim_mask
    cross = torch.einsum("qmd,smd->qs", qc, recon)
    rs = (recon ** 2).sum(dim=(1, 2))
    d = rs[None, :] - 2.0 * cross  # rank-only (|q|^2 is constant per row)
    if b == 1:
        idx = torch.argmin(d, dim=1, keepdim=True)
    else:
        idx = torch.sort(d, dim=1, stable=True).indices[:, : min(b, s)]
    out = ids[idx].to(torch.int32)
    if b > out.shape[1]:
        out = torch.cat([out, out[:, :1].expand(-1, b - out.shape[1])], dim=1)
    return out


def _base_finish(state: BaseState, k: int):
    """The k nearest expanded nodes by exact distance: (ids [Q, k] int32,
    dists [Q, k] f32). A stable ascending sort, as `lax.top_k` orders ties
    (lowest slot first); `torch.topk` leaves their order unspecified."""
    sd, order = torch.sort(state.l2_dists, dim=1, stable=True)
    return state.visited_ids.gather(1, order[:, :k]), sd[:, :k]


class _SubBatch:
    """One pipeline sub-batch of q queries, kept from call to call while the
    searcher's key holds: its CUDA stream, event, pinned staging (nbrs,
    vecs; written by the host gather) and readback (parents, active)
    buffers; its static query buffer on the device; once captured, the
    graphs of its prologue and step, their pool and their static buffers.
    Device work is enqueued inside its stream's context (the caching
    allocator ties memory to the stream it was allocated on)."""

    def __init__(self, searcher, q: int, params: SearchParams):
        dev = searcher.device
        beam = params.beam_width
        cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if cuda else None
        self.event = torch.cuda.Event() if cuda else None
        self.nbrs_host = torch.empty((q, beam * searcher.meta.degree),
                                     dtype=torch.int32, pin_memory=cuda)
        self.vecs_host = torch.empty((q, beam, searcher.vec_bytes), dtype=torch.uint8,
                                     pin_memory=cuda)
        self.parents_host = torch.zeros((q, beam), dtype=torch.int32, pin_memory=cuda)
        self.active_host = torch.ones((1,), dtype=torch.bool, pin_memory=cuda)
        with self.context():
            self.queries = torch.empty((q, searcher.meta.dim), dtype=torch.float32,
                                       device=dev)
        self.graphs = None  # (prologue, step) once captured

    def context(self):
        """This sub-batch's stream as the current one (nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _prologue(self, searcher, params: SearchParams):
        """Tables, entries and the initial state of self.queries."""
        self.tables = searcher._prepare_tables(self.queries)
        self.entries = searcher._select_entries(self.queries, self.tables, params,
                                                params.beam_width)
        self.state = _init_state(self.queries.shape[0], params.L, params.max_iters,
                                 self.entries, params.beam_width,
                                 params.visited_mode == "bloom")

    def begin(self, searcher, queries: np.ndarray, params: SearchParams, current):
        """Start a call on `queries`: the prologue (its graph's replay once
        captured), then the entries copied to the parents' staging, a
        blocking copy that waits for this stream."""
        if self.stream is not None:
            self.stream.wait_stream(current)  # the codes and codebook uploads
        with self.context():
            self.queries.copy_(compiled.device_queries(queries, self.queries))
            if self.graphs is None:
                self._prologue(searcher, params)
            else:
                self.graphs[0].replay()
            self.parents_host[:, : self.entries.shape[1]].copy_(self.entries)
        self.pending = False  # a step was dispatched and not read back yet
        self.done = False

    def dispatch(self, searcher, beam: int) -> None:
        """Enqueue one step from the staging: the host-to-device copies, the
        step (its graph's replay once captured),
        the readback copies of the next parents and the flag, the event.
        The staging may be rewritten only after the event."""
        dev = searcher.device
        with self.context():
            if self.graphs is None:
                nbrs = self.nbrs_host.to(dev, non_blocking=True)
                vecs = self.vecs_host.to(dev, non_blocking=True).view(searcher.vec_dtype)
                self.state, parents, active_any = searcher._run_step(
                    self.state, nbrs, vecs, self.queries, self.tables, beam)
            else:
                self.nbrs.copy_(self.nbrs_host, non_blocking=True)
                self.vecs.copy_(self.vecs_host, non_blocking=True)
                self.graphs[1].replay()
                parents, active_any = self.step_out
            self.parents_host.copy_(parents, non_blocking=True)
            self.active_host.copy_(active_any.view(1), non_blocking=True)
            if self.event is not None:
                self.event.record()

    def capture(self, searcher, params: SearchParams) -> None:
        """Capture the prologue and the step on this sub-batch's stream,
        into one memory pool of its own; the static nbrs and vecs buffers
        feed the step. Runs after an eager call, which warmed them up.
        Records `capture_s` and `graph_bytes` (the pool and the two
        buffers)."""
        beam = params.beam_width
        dev = searcher.device
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as each capture does: the pool's bytes show
        reserved = torch.cuda.memory_reserved(dev)
        with self.context():
            self.nbrs = torch.empty_like(self.nbrs_host, device=dev)
            self.vecs = torch.empty_like(self.vecs_host, device=dev)
        pro, step = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        compiled.capture(pro, lambda: self._prologue(searcher, params), dev,
                         stream=self.stream)

        def body():
            new, parents, active_any = searcher._run_step(
                self.state, self.nbrs, self.vecs.view(searcher.vec_dtype),
                self.queries, self.tables, beam)
            for old, value in zip(self.state, new):
                if value is not old:
                    old.copy_(value)
            return parents, active_any

        self.step_out = compiled.capture(step, body, dev, pool=pro.pool(),
                                         stream=self.stream)
        self.graphs = (pro, step)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.graph_bytes = torch.cuda.memory_reserved(dev) - reserved

    def wait(self) -> None:
        """Block until this sub-batch's last step and readback have run."""
        if self.event is not None:
            self.event.synchronize()


class BaseVariantSearcher:
    """Host-RAM-graph searcher (the BANGSearch facade's billion-scale engine).

    Only the PQ codes and the codebook live on `device`; the packed graph
    file is memory-mapped (mmap=True) or read into RAM, as the reference's
    `pIndex` (bang_search.cu:311-328). n_pipeline_batches: query sub-batches
    kept in flight; n_threads: host gather threads (0: one per core, at most
    32). `last_n_steps` counts the device steps of the last search,
    `last_n_d2h` its readback waits, and `timers` its stages when enabled
    (see `search`)."""

    def __init__(
        self,
        prefix: str,
        n_pipeline_batches: int = 4,
        n_threads: int = 0,
        mmap: bool = True,
        keep_codes_on_host: bool = False,
        device="cuda",
    ):
        """keep_codes_on_host: leave the [N, m] code matrix in host RAM
        (`codes_np`, `codes` None) instead of copying it whole to `device`,
        for a subclass that splits it over several devices
        (parallel/base_tp.ShardedBaseSearcher), where the whole matrix may
        not fit one device's memory."""
        self.device = resolve_device(device)
        self.meta = load_metadata(prefix + GRAPH_METADATA_FILE_SUFFIX)
        path = prefix + GRAPH_INDEX_FILE_SUFFIX
        n, entry_len = self.meta.n, self.meta.entry_len
        if mmap:
            self.raw = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, entry_len))
        else:
            self.raw = np.fromfile(path, dtype=np.uint8, count=n * entry_len).reshape(
                n, entry_len
            )
        pq = load_pq(prefix)
        if keep_codes_on_host:
            self.codes_np, self.codes = np.asarray(pq.codes), None
        else:
            self.codes = torch.tensor(pq.codes, device=self.device)  # [N, m] u8
        self.codebook = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets,
                                            self.device)
        self.vec_bytes = self.meta.dim * self.meta.numpy_dtype.itemsize
        self.vec_dtype = _TORCH_DTYPE[self.meta.dtype_code]
        self.n_pipeline_batches = n_pipeline_batches
        self.n_threads = n_threads
        self.timers = StageTimers(enabled=False)
        self.last_n_steps = 0
        self.last_n_d2h = 0
        self._subs_key, self._subs = None, []  # the sub-batches of one key

    # capture each sub-batch's prologue and step on the card (a subclass
    # whose step spans several devices sets False)
    captured = True

    def drop_graphs(self) -> None:
        """Free the sub-batches, their graphs and their pools."""
        self._subs_key, self._subs = None, []

    def _prepare_tables(self, sub_queries):
        """A sub-batch's PQ tables, in whatever form `_run_step` and
        `_select_entries` take them: here the distance function of
        traversal.make_pq_distance_fn (on the card the tables are packed
        once and K1 reads them for codes[nbrs]; on the CPU the f32 tables
        and ops/pq.pq_lookup, as JAX's `pq_impl="auto"`)."""
        return make_pq_distance_fn(sub_queries, self.codebook, self.codes)

    def _run_step(self, state, nbrs, parent_vecs, queries_f32, tables, beam):
        """One device step: the PQ lookup, then the shared step core."""
        return _step_core(state, nbrs, parent_vecs, queries_f32, tables(nbrs), beam)

    def _select_entries(self, sub_queries, tables, params, beam):
        """One sub-batch's entry points, [q_b, P] int32 on the device: the
        shared medoid, or the per-query sampled entries. `tables` is what
        `_prepare_tables` made for the sub-batch (the chunk-sharded
        subclass ranks its sample with them)."""
        if params.entry_mode != "sampled":
            return torch.full((sub_queries.shape[0], 1), self.meta.medoid,
                              dtype=torch.int32, device=sub_queries.device)
        return _sampled_entry_base(sub_queries, self.codes, self.codebook,
                                   params.entry_samples, beam)

    def _host_gather(self, parents: np.ndarray, out_nbrs=None, out_vecs=None):
        """(nbrs [Q, R] int32, vecs [Q, vec_bytes] u8) for parents [Q]: the
        vectors' bytes ship unconverted and the device views them as the
        storage dtype (1 byte a dimension over the host link for u8/i8
        data, as the reference ships them, bang_search.cu:771-813). Writes
        into out_nbrs / out_vecs when given."""
        m = self.meta
        return gather_parents(
            self.raw, m.entry_len, self.vec_bytes, m.dim, m.degree, m.dtype_code,
            parents, n_threads=self.n_threads, raw_vecs=True,
            out_nbrs=out_nbrs, out_vecs=out_vecs,
        )

    def search(self, queries: np.ndarray, params: SearchParams):
        """Batched search. Returns (ids [Q, k] int32, dists [Q, k] f32) as
        numpy arrays.

        Stage timers (per search, enabled via ENABLE_GPU_STATS):
          host_gather  — host work: the threaded adjacency + vector row fetch
                         into the sub-batch's pinned staging
          d2h_parents  — per outer iteration, ONE wait on the events of all
                         in-flight sub-batches (their steps and the copies of
                         their next parents; includes waiting for the
                         slowest sub-batch's step)
          dispatch     — the staging's host-to-device copies and the step,
                         enqueued on the sub-batch's stream
          wall         — end-to-end search wall clock
        host_gather + d2h_parents + dispatch > wall would mean the host
        gather ran while the card computed; the direct proof is the same
        search with n_pipeline_batches=1 taking longer."""
        check_params(params)
        assert_exact_float32()
        queries = np.asarray(queries, dtype=np.float32)
        self.timers.ms.clear()
        t_wall = time.perf_counter()
        dev = self.device
        q_total = queries.shape[0]
        nb = min(self.n_pipeline_batches, q_total)
        bounds = tuple(np.linspace(0, q_total, nb + 1).astype(int).tolist())
        beam = params.beam_width
        r = self.meta.degree
        current = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        key = (bounds, params)
        if key != self._subs_key:
            self._subs = [_SubBatch(self, bounds[i + 1] - bounds[i], params)
                          for i in range(nb)]
            self._subs_key = key
        subs = self._subs
        for i, sb in enumerate(subs):
            sb.begin(self, queries[bounds[i] : bounds[i + 1]], params, current)
        self.last_n_steps = 0  # device steps dispatched (all sub-batches)
        self.last_n_d2h = 0  # readback waits (one per outer iteration)

        for _ in range(1, params.max_iters):
            live = [sb for sb in subs if not sb.done]
            if not live:
                break
            in_flight = [sb for sb in live if sb.pending]
            if in_flight:
                with self.timers.stage("d2h_parents"):
                    for sb in in_flight:
                        sb.wait()
                    self.last_n_d2h += 1
                for sb in in_flight:
                    sb.pending = False
                    sb.done = not bool(sb.active_host[0])
            for sb in live:
                if sb.done:
                    continue
                with self.timers.stage("host_gather"):
                    # invalid parents are 0 (select_parents_beam): row 0 is
                    # gathered and the step masks it
                    self._host_gather(sb.parents_host.numpy().reshape(-1),
                                      sb.nbrs_host.numpy().reshape(-1, r),
                                      sb.vecs_host.numpy().reshape(-1, self.vec_bytes))
                with self.timers.stage("dispatch"):
                    sb.dispatch(self, beam)
                sb.pending = True
                self.last_n_steps += 1

        for sb in subs:  # drain the in-flight steps
            if sb.stream is not None:
                sb.stream.synchronize()
        finished = [_base_finish(sb.state, params.k) for sb in subs]
        ids = torch.cat([f[0] for f in finished])
        dists = torch.cat([f[1] for f in finished])
        # one device-to-host copy of ids and distances (the f32 bits ride as
        # int32)
        out = torch.cat([ids, dists.view(torch.int32)], dim=1).cpu()
        k = params.k
        if self.captured and dev.type == "cuda":
            for sb in subs:
                if sb.graphs is None:
                    sb.capture(self, params)
        if self.timers.enabled:
            self.timers.ms["wall"] += (time.perf_counter() - t_wall) * 1000.0
        return out[:, :k].numpy(), out[:, k:].view(torch.float32).numpy()
