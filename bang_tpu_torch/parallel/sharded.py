"""Multi-device search over a (data, model) device mesh (port of
bang_tpu/parallel/sharded.py).

Two composable strategies, as in the JAX package:

  * data parallelism — queries split over the 'data' axis; each row of
    the mesh searches its own query slice on a replica of the index;
  * index (model) parallelism — the dataset split over the 'model' axis
    into independent sub-indices (parallel/partition.py); each device
    searches its shard for its row's queries, then the per-shard top-k
    lists are gathered over 'model' and merged with a final top-k. The
    merge is the only communication: k ids + k f32 distances per query per
    shard.

JAX runs these under `shard_map`, which is single-controller: one process
drives every device of the mesh and gets global arrays back. The port
keeps that contract without torch.distributed. A `Mesh` is a [data, model]
grid of torch devices, each device's share runs on that device, and the
two collectives are explicit:

  all_gather over 'model'  each shard's results moved (`.to`) to the row's
                           first device and stacked in shard order;
  psum over 'model'        the shard-order sum of [Q, C] partials on one
                           device (parallel/pq_tp.py, parallel/base_tp.py).

On CUDA devices each share's walk is its captured loop (models/compiled.py:
one graph launch runs the whole search of a share), every walk is enqueued
before any result is read, and the caller's readback is the one wait; the
graphs live in the index's graph cache, and the first call of a key runs
the rounds below, then captures each walk. On the CPU every share's walk
steps in rounds with the others (models/traversal.traverse_together): one
host read of all their flags a round, so shares on distinct devices run
at once. A mesh may name one device more than once ([cuda:0] * 4, [cpu] *
8): the shares then take turns on it. That is how the tests drive these
paths (8 CPU positions, as the JAX tests use 8 virtual CPU devices) and how
one card runs them. An index is placed once per distinct device. A
multi-process NCCL backend, for meshes spread over hosts or processes, is
not ported (ROADMAP Queue 1 item 18).
"""

from __future__ import annotations

import torch

from bang_tpu_torch.device import assert_exact_float32, resolve_device
from bang_tpu_torch.models import compiled
from bang_tpu_torch.models.index import layout_of
from bang_tpu_torch.models.traversal import (
    SearchStats,
    check_params,
    make_exact_distance_fn,
    make_pq_distance_fn,
    rerank_topk,
    start_traversal,
    traverse,
    traverse_together,
)
from bang_tpu_torch.utils.config import SearchParams


class Mesh:
    """A [data][model] grid of torch devices (`devices[i][j]`: data row i,
    model column j). `home` is devices[0][0], where results are returned."""

    def __init__(self, devices):
        self.devices = [list(row) for row in devices]

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    @property
    def key(self) -> tuple:
        """The grid as a hashable value (part of a graph-cache key)."""
        return tuple(tuple(row) for row in self.devices)


def _explicit(device) -> torch.device:
    """`device` resolved (a CUDA device that is not there raises), with the
    current CUDA index filled in, so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(data: int, model: int, devices=None) -> Mesh:
    """(data, model) mesh over the first data*model of `devices`, row-major.

    devices=None: every CUDA device. Fewer devices than data*model raise
    ValueError (JAX asserts). A list may repeat a device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(devices) < data * model:
        raise ValueError(f"need {data * model} devices, have {len(devices)}")
    devs = [_explicit(d) for d in devices[: data * model]]
    return Mesh([devs[i * model : (i + 1) * model] for i in range(data)])


def all_gather(parts, dst) -> torch.Tensor:
    """The all_gather over 'model': the shards' tensors, in shard order,
    stacked on `dst` ([S, ...])."""
    return torch.stack([p.to(dst) for p in parts])


def psum(parts, dst) -> torch.Tensor:
    """The psum over 'model': the shards' tensors summed on `dst`, in shard
    order ((p0 + p1) + p2 ...)."""
    out = parts[0].to(dst)
    for p in parts[1:]:
        out = out + p.to(dst)
    return out


def _local_start(adj, vectors, codes, fused_rows, codebook, medoid, queries, *,
                 l, max_iters, use_bloom, beam=1, nbr_codes=None, pq_impl="auto"):
    """The start of one shard's search for one query slice on the shard's
    device: (step, state, queries_f32), for traversal.traverse or
    traverse_together, then `_local_finish`.

    PQ shards take the single-device op point: the fused rows when the
    shard has them (K2 on the card), else the neighbor-aligned code rows
    when it has them, else the scattered codes (K1 on the card for both);
    the f32 tables on the CPU; pq_impl as traversal.make_pq_distance_fn
    takes it. Exact shards run the scattered exact traversal (JAX's
    sharded exact path has no fused exact rows). The JAX function's
    `norms` is not taken: no port path reads it."""
    queries_f32 = queries.float()
    if codes is not None:
        distance_fn = make_pq_distance_fn(queries_f32, codebook, codes,
                                          fused_rows=fused_rows,
                                          nbr_codes=nbr_codes, impl=pq_impl)
    else:
        distance_fn = make_exact_distance_fn(queries_f32, vectors)
    step, state = start_traversal(adj, distance_fn, medoid, queries.shape[0], l,
                                  max_iters, beam, queries.device, use_bloom=use_bloom)
    return step, state, queries_f32


def _local_finish(vectors, id_base, queries_f32, final, *, k, rerank, exact):
    """One shard's global-id top-k from its final state: (ids [q, k] int32,
    dists [q, k] f32). `rerank` is honoured; exact shards are always
    re-ranked, as in JAX."""
    if rerank or exact:
        ids, dists = rerank_topk(queries_f32, vectors, final.visited_ids, k)
    else:
        ids, dists = final.wl_ids[:, :k], final.wl_dist[:, :k]
    # INVALID_ID padding must not collide with real global ids after offset
    return torch.where(ids < 0, ids, ids + id_base), dists


def _local_search(adj, vectors, codes, fused_rows, codebook, medoid, id_base,
                  queries, *, l, k, max_iters, use_bloom, beam=1, rerank=True,
                  nbr_codes=None, pq_impl="auto"):
    """Search one shard for one query slice on its own, start to finish
    (the per-shard loop that search_sharded's rounds reproduce); returns
    global-id top-k (ids [q, k] int32, dists [q, k] f32)."""
    step, state, queries_f32 = _local_start(
        adj, vectors, codes, fused_rows, codebook, medoid, queries, l=l,
        max_iters=max_iters, use_bloom=use_bloom, beam=beam, nbr_codes=nbr_codes,
        pq_impl=pq_impl)
    final = traverse(step, state, max_iters)
    return _local_finish(vectors, id_base, queries_f32, final, k=k, rerank=rerank,
                         exact=codes is None)


def merge_topk(all_ids: torch.Tensor, all_dists: torch.Tensor, k: int):
    """[S, q, k] per-shard lists -> the global top-k, (ids [q, k], dists
    [q, k]). Candidates are laid out shard-major per query ([q, S*k]) and
    ranked by a stable ascending sort: ties go to the lower position, as
    `lax.top_k` orders them (`torch.topk` leaves their order unspecified;
    u8 data gives integer distances and frequent ties)."""
    s, q, kk = all_ids.shape
    flat_ids = all_ids.transpose(0, 1).reshape(q, s * kk)
    flat_d = all_dists.transpose(0, 1).reshape(q, s * kk)
    sd, order = torch.sort(flat_d, dim=1, stable=True)
    return flat_ids.gather(1, order[:, :k]), sd[:, :k]


def _query_rows(mesh: Mesh, queries):
    """The queries as a tensor, split into the mesh's data rows (JAX's
    P("data") needs an even split; so does the port)."""
    qt = torch.as_tensor(queries)
    n_data = mesh.shape["data"]
    if qt.shape[0] % n_data:
        raise ValueError(f"{qt.shape[0]} queries do not split evenly over "
                         f"{n_data} data rows")
    return qt.chunk(n_data) if n_data > 1 else (qt,)


def _refuse_sampled(params: SearchParams, fn: str) -> None:
    """The sharded searches enter at the medoid: JAX's ignore entry_mode
    (its data-parallel search calls the jitted in-memory search without
    entry samples), so sampled entry would return other ids than the
    reference's. Refused rather than ignored."""
    if params.entry_mode == "sampled":
        raise ValueError(f"{fn} enters every shard at its medoid; "
                         "entry_mode='sampled' is served by the single-device "
                         "searches only")


def search_sharded(mesh: Mesh, sharded_index, queries, params: SearchParams,
                   stats: list | None = None):
    """Search a node-sharded index (parallel/partition.ShardedIndex) over
    the mesh.

    Queries are split over 'data', the shards over 'model'; each (row,
    shard) search runs on its device: on CUDA devices its captured loop,
    all enqueued before any is read; on the CPU all step together in
    rounds (traversal.traverse_together: one host read of every still-live
    shard's flag per round), each taking exactly the iterations it would
    take alone. Then each row's per-shard lists are gathered on the row's
    first device and merged. Every shard's state is held at once (in bloom
    mode a [q, 399,889] u8 filter each). Returns (ids [Q, k] int32 global
    ids, dists [Q, k] f32) on mesh.home, with no host wait on the card;
    each walk's SearchStats are appended to `stats` when given.
    entry_mode="sampled" raises ValueError."""
    check_params(params)
    _refuse_sampled(params, "search_sharded")
    assert_exact_float32()
    si = sharded_index
    n_model = mesh.shape["model"]
    if si.n_shards != n_model:
        raise ValueError(f"index has {si.n_shards} shards, mesh 'model' axis "
                         f"{n_model}")
    use_bloom = params.visited_mode == "bloom"
    walks = []
    for row, qs in zip(mesh.devices, _query_rows(mesh, queries)):
        for s, dev in enumerate(row):
            sh = si.shard(s, dev)
            walks.append((dev, qs.to(dev), _shard_start(sh, params, use_bloom),
                          _shard_finish(sh, params)))
    done = _walk_all(si, ("sharded", layout_of(si), mesh.key, qs.shape, params), walks,
                     params.max_iters, mesh.home, stats)
    out_ids, out_dists = [], []
    for r, row in enumerate(mesh.devices):
        parts = [done[r * n_model + s][0] for s in range(n_model)]
        i, d = merge_topk(all_gather([p[0] for p in parts], row[0]),
                          all_gather([p[1] for p in parts], row[0]), params.k)
        out_ids.append(i.to(mesh.home))
        out_dists.append(d.to(mesh.home))
    return torch.cat(out_ids), torch.cat(out_dists)


def _shard_start(sh, params: SearchParams, use_bloom: bool):
    def start(queries):
        return _local_start(sh.adj, sh.vectors, sh.codes, sh.fused_rows, sh.codebook,
                            sh.medoid, queries, l=params.L, max_iters=params.max_iters,
                            use_bloom=use_bloom, beam=params.beam_width,
                            nbr_codes=sh.nbr_codes, pq_impl=params.pq_impl)
    return start


def _shard_finish(sh, params: SearchParams):
    def finish(queries_f32, final):
        return _local_finish(sh.vectors, sh.id_base, queries_f32, final, k=params.k,
                             rerank=params.rerank, exact=sh.codes is None)
    return finish


def _walk_all(owner, key, walks, max_iters: int, home, stats=None) -> list:
    """Run independent walks, each `(device, queries, start, finish)` (the
    prologue and epilogue of models/compiled.CapturedLoop); returns
    [(finish's tensors, SearchStats)] in the walks' order, appending the
    stats to `stats` when given.

    On CUDA devices: each walk's captured loop from `owner`'s graph cache,
    all enqueued with no host wait. Otherwise, and at a key's first call on
    the card (then each walk is captured after): the rounds of
    traversal.traverse_together."""
    cuda = all(dev.type == "cuda" for dev, *_ in walks)
    cache = compiled.graph_cache(owner) if cuda else None
    loops = [cache.get(key, i) for i in range(len(walks))] if cuda else []
    if cuda and all(loop is not None for loop in loops):
        done = [loop.launch(q) for loop, (_, q, _, _) in zip(loops, walks)]
    else:
        queries = [compiled.device_queries(q, torch.empty(0, device=dev))
                   for dev, q, _, _ in walks]
        started = [start(q) for q, (_, _, start, _) in zip(queries, walks)]
        finals = traverse_together([(step, state) for step, state, _ in started],
                                   max_iters, home)
        done = [(finish(ctx, f), SearchStats(f.it, f.n_expanded, f.n_dist_comps))
                for (_, _, ctx), f, (_, _, _, finish) in zip(started, finals, walks)]
        if cuda:
            for i, (q, (_, _, start, finish)) in enumerate(zip(queries, walks)):
                cache.put(i, compiled.CapturedLoop(start, finish, (q,), max_iters))
    if stats is not None:
        stats.extend(st for _, st in done)
    return done


def search_data_parallel(mesh: Mesh, index, queries, params: SearchParams,
                         stats: list | None = None):
    """Query-data-parallel search of a replicated in-memory index
    (models/index.DeviceIndex): each data row searches its query slice with
    models/inmemory's search on a replica of the index on its first device
    (one replica per distinct device; the JAX program also repeats the
    search along 'model', which gives the same answers). The rows step
    together in rounds on the CPU and run their captured loops on the card,
    as search_sharded's shards do. Returns (ids [Q, k] int32, dists [Q, k]
    f32) on mesh.home; each row's SearchStats are appended to `stats` when
    given. entry_mode="sampled" raises ValueError."""
    from bang_tpu_torch.models.inmemory import finish_inmemory, prepare_inmemory

    _refuse_sampled(params, "search_data_parallel")
    replicas, walks = {}, []
    for row, qs in zip(mesh.devices, _query_rows(mesh, queries)):
        dev = row[0]
        if dev not in replicas:
            replicas[dev] = index.to(dev)
        replica = replicas[dev]
        walks.append((dev, qs.to(dev),
                      lambda q, replica=replica: prepare_inmemory(replica, q, params),
                      lambda queries_f32, final, replica=replica: finish_inmemory(
                          replica, queries_f32, final, params)[:2]))
    done = _walk_all(index, ("data_parallel", layout_of(index), mesh.key, qs.shape,
                             params), walks,
                     params.max_iters, mesh.home, stats)
    return (torch.cat([ids.to(mesh.home) for (ids, _), _ in done]),
            torch.cat([dists.to(mesh.home) for (_, dists), _ in done]))
