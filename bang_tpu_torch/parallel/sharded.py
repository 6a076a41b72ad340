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

A mesh may name one device more than once ([cuda:0] * 4, [cpu] * 8): the
shares then run one after another on it. That is how the tests drive these
paths (8 CPU positions, as the JAX tests use 8 virtual CPU devices) and how
one card runs them. An index is placed once per distinct device. A
multi-process NCCL backend, for meshes spread over hosts or processes, is
not ported (ROADMAP Queue 1 item 18).
"""

from __future__ import annotations

import torch

from bang_tpu_torch.device import assert_exact_float32, resolve_device
from bang_tpu_torch.models.traversal import (
    check_params,
    make_exact_distance_fn,
    make_pq_distance_fn,
    rerank_topk,
    run_traversal,
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


def _local_search(adj, vectors, codes, fused_rows, codebook, medoid, id_base,
                  queries, *, l, k, max_iters, use_bloom, beam=1, rerank=True):
    """Search one shard for one query slice on the shard's device; returns
    global-id top-k (ids [q, k] int32, dists [q, k] f32).

    PQ shards take the single-device op point: the fused rows when the
    shard has them (K2 on the card), else the scattered codes (K1 on the
    card); the f32 tables on the CPU (traversal.make_pq_distance_fn).
    Exact shards run the scattered exact traversal (JAX's sharded exact
    path has no fused exact rows). `rerank` is honoured; exact shards are
    always re-ranked, as in JAX. The JAX function's `norms` and
    `nbr_codes` are not taken: no port path reads them."""
    q = queries.shape[0]
    queries_f32 = queries.float()
    if codes is not None:
        distance_fn = make_pq_distance_fn(queries_f32, codebook, codes,
                                          fused_rows=fused_rows)
    else:
        distance_fn = make_exact_distance_fn(queries_f32, vectors)
    final = run_traversal(adj, distance_fn, medoid, q, l, max_iters, beam,
                          queries.device, use_bloom=use_bloom)
    if rerank or codes is None:
        ids, dists = rerank_topk(queries_f32, vectors, final.visited_ids, k)
    else:
        ids, dists = final.wl_ids[:, :k], final.wl_dist[:, :k]
    # INVALID_ID padding must not collide with real global ids after offset
    return torch.where(ids < 0, ids, ids + id_base), dists


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


def search_sharded(mesh: Mesh, sharded_index, queries, params: SearchParams):
    """Search a node-sharded index (parallel/partition.ShardedIndex) over
    the mesh.

    Queries are split over 'data', the shards over 'model'; each (row,
    shard) search runs on its device, then each row's per-shard lists are
    gathered on the row's first device and merged. Returns (ids [Q, k]
    int32 global ids, dists [Q, k] f32) on mesh.home."""
    check_params(params)
    assert_exact_float32()
    si = sharded_index
    n_model = mesh.shape["model"]
    if si.n_shards != n_model:
        raise ValueError(f"index has {si.n_shards} shards, mesh 'model' axis "
                         f"{n_model}")
    use_bloom = params.visited_mode == "bloom"
    out_ids, out_dists = [], []
    for row, qs in zip(mesh.devices, _query_rows(mesh, queries)):
        ids, dists = [], []
        for s, dev in enumerate(row):
            sh = si.shard(s, dev)
            i, d = _local_search(
                sh.adj, sh.vectors, sh.codes, sh.fused_rows, sh.codebook,
                sh.medoid, sh.id_base, qs.to(dev),
                l=params.L, k=params.k, max_iters=params.max_iters,
                use_bloom=use_bloom, beam=params.beam_width, rerank=params.rerank,
            )
            ids.append(i)
            dists.append(d)
        i, d = merge_topk(all_gather(ids, row[0]), all_gather(dists, row[0]),
                          params.k)
        out_ids.append(i.to(mesh.home))
        out_dists.append(d.to(mesh.home))
    return torch.cat(out_ids), torch.cat(out_dists)


def search_data_parallel(mesh: Mesh, index, queries, params: SearchParams):
    """Query-data-parallel search of a replicated in-memory index
    (models/index.DeviceIndex): each data row searches its query slice with
    models/inmemory.search_inmemory on a replica of the index on its first
    device (one replica per distinct device; the JAX program also repeats
    the search along 'model', which gives the same answers). Returns (ids
    [Q, k] int32, dists [Q, k] f32) on mesh.home."""
    from bang_tpu_torch.models.inmemory import search_inmemory

    replicas = {}
    out_ids, out_dists = [], []
    for row, qs in zip(mesh.devices, _query_rows(mesh, queries)):
        dev = row[0]
        if dev not in replicas:
            replicas[dev] = index.to(dev)
        ids, dists, _stats = search_inmemory(replicas[dev], qs.to(dev), params)
        out_ids.append(ids.to(mesh.home))
        out_dists.append(dists.to(mesh.home))
    return torch.cat(out_ids), torch.cat(out_dists)
