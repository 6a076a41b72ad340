"""Streaming (mutable) index: online inserts, lazy deletes, consolidation
(port of bang_tpu/models/streaming.py).

Beyond the reference, which searches a frozen DiskANN index (README.md:42-58):
FreshVamana-style updates (the public FreshDiskANN algorithm: insert = the
incremental Vamana insert; delete = tombstone + deferred repair) over the
device-resident build machinery:

  * insert — `formats/vamana._insert_batch` is an online insert (greedy
    search over the live graph + alpha robust prune + reverse edges).
    Capacity is allocated up front; freed slots are reused before the
    high-water mark grows.
  * delete — tombstones. The traversal still routes through deleted nodes
    (unlinking them eagerly would disconnect the graph); search results
    filter them out.
  * consolidate — repairs every row that points at a tombstone by robust-
    pruning the union of its live edges and its deleted neighbors'
    neighborhoods (the FreshDiskANN repair rule), in batches, then frees the
    tombstone slots and elects a new medoid if the old one was deleted.

`deleted` doubles as the "not live" mask: empty slots start deleted, insert
clears the flag, delete sets it. The tensors hold capacity + 1 rows: row
`capacity` is the trash row that `_insert_batch` aims the writes at that
the JAX scatters drop; it is deleted forever, so no search or repair takes
it for a live node. The search is the exact scattered traversal (plain
PyTorch, no kernel), as in the JAX package, on the eager loop
(traversal.traverse, one host read an iteration), not the captured one of
models/compiled.py: the graph changes between searches and each batch
builds new query tensors (ROADMAP Queue 1 item 13b). Ties in the result
and in the batch peers break lowest index first (a stable sort, as
`lax.top_k`).
"""

from __future__ import annotations

import numpy as np
import torch

from bang_tpu_torch.constants import INVALID_ID
from bang_tpu_torch.device import assert_exact_float32, resolve_device
from bang_tpu_torch.formats.vamana import _insert_batch, _prune_ids
from bang_tpu_torch.models.traversal import make_exact_distance_fn, run_traversal
from bang_tpu_torch.utils.config import SearchParams


def _search_streaming(adj, vectors, deleted, queries, medoid: int, l: int, k: int,
                      max_iters: int, beam: int):
    """Exact traversal from `medoid`, then the k nearest live worklist
    entries: (ids [Q, k] int32, INVALID_ID padded; dists [Q, k] f32, +inf
    padded; iterations)."""
    q = queries.shape[0]
    queries_f32 = queries.float()
    dist_fn = make_exact_distance_fn(queries_f32, vectors)
    final = run_traversal(adj, dist_fn, medoid, q, l, max_iters, beam, queries.device)
    # tombstones occupy worklist slots during the walk (routing through them
    # keeps the graph connected) but are filtered from the answer
    wl_ids, wl_dist = final.wl_ids, final.wl_dist
    dead = deleted[wl_ids.clamp_min(0).long()] | (wl_ids == INVALID_ID)
    d = wl_dist.masked_fill(dead, float("inf"))
    sd, order = torch.sort(d, dim=1, stable=True)
    sd = sd[:, :k]
    ids = wl_ids.gather(1, order[:, :k]).masked_fill(torch.isinf(sd), INVALID_ID)
    return ids, sd, final.it


def _repair_batch(adj, degrees, vectors, norms, deleted, row_ids, r: int, alpha: float):
    """Repair the rows `row_ids` that point at tombstones (one consolidation
    batch), in place; returns how many rows were repaired (device scalar).

    A row's candidate pool is its live edges plus the full neighborhoods of
    its deleted neighbors (tombstones masked); the alpha robust prune keeps
    at most r. Rows with no deleted edge, or deleted themselves, keep their
    edges. Repeated ids in `row_ids` compute the same row from the same
    input and count once each, as in the JAX package."""
    ids = row_ids.long()
    rows = adj[ids]  # [B, R]
    self_pad = rows == row_ids[:, None]
    nbr_deleted = deleted[rows.long()] & ~self_pad
    needs = nbr_deleted.any(dim=1) & ~deleted[ids]

    b = rows.shape[0]
    # deleted neighbors' neighborhoods (only where the edge was deleted)
    expanded = adj[rows.long()].reshape(b, -1)  # [B, R*R]
    exp_mask = nbr_deleted.repeat_interleave(rows.shape[1], dim=1)
    expanded = expanded.masked_fill(~exp_mask, -1)
    kept = rows.masked_fill(nbr_deleted | self_pad, -1)
    cand = torch.cat([kept, expanded], dim=1)
    # tombstones never re-enter the adjacency
    cand = cand.masked_fill(deleted[cand.clamp_min(0).long()], -1)

    new_rows, new_deg = _prune_ids(vectors, norms, row_ids, cand, r, alpha)
    adj[ids] = torch.where(needs[:, None], new_rows, rows)
    degrees[ids] = torch.where(needs, new_deg, degrees[ids])
    return needs.sum()


def _batch_peers(vecs, ids, p: int):
    """Top-p nearest peer ids within the batch, per batch point ([B, p]
    int32): one [B, B] product, self excluded. Joined into the insert's
    candidate pool so that simultaneous inserts can link to each other."""
    v = vecs.float()
    n2 = (v * v).sum(-1)
    d = n2[:, None] + n2[None, :] - 2.0 * (v @ v.T)
    d.fill_diagonal_(float("inf"))
    idx = torch.sort(d, dim=1, stable=True).indices[:, :p]
    return ids[idx]


def _elect_medoid(vectors, norms, deleted) -> int:
    """The live point nearest the live centroid (the first on a tie)."""
    live = ~deleted
    cnt = live.sum().clamp_min(1)
    v = vectors.float()
    centroid = v.masked_fill(~live[:, None], 0.0).sum(0) / cnt
    d = (norms - 2.0 * (v @ centroid)).masked_fill(~live, float("inf"))
    return int(torch.argmin(d))


class StreamingIndex:
    """Mutable exact-traversal index with a fixed capacity, on `device`.

    All tensors live on the device at full capacity (plus the trash row);
    `deleted` marks both tombstones and never-used slots, so "live" is
    exactly `~deleted`. `medoid`, `hwm` (the high-water mark: slots ever
    allocated), `free` (consolidated slots, reused first) and
    `n_tombstones` are host values."""

    def __init__(self, capacity: int, dim: int, r: int = 32,
                 dtype=np.float32, l_build: int = 48, alpha: float = 1.44,
                 k_overflow: int = 512, device="cuda"):
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.r = int(r)
        self.l_build = int(l_build)
        self.alpha = float(alpha)
        self.k_overflow = int(k_overflow)
        rows = self.capacity + 1  # + the trash row
        dev = self.device
        tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        self.vectors = torch.zeros((rows, dim), dtype=tdtype, device=dev)
        self.norms = torch.zeros((rows,), dtype=torch.float32, device=dev)
        iota = torch.arange(rows, dtype=torch.int32, device=dev)
        self.adj = iota[:, None].expand(rows, self.r).contiguous()
        self.degrees = torch.zeros((rows,), dtype=torch.int32, device=dev)
        self.deleted = torch.ones((rows,), dtype=torch.bool, device=dev)  # empty == deleted
        self.medoid = 0
        self.hwm = 0
        self.free: list[int] = []
        self.n_tombstones = 0

    @classmethod
    def from_built(cls, vectors: np.ndarray, adj: np.ndarray,
                   degrees: np.ndarray, medoid: int, capacity: int,
                   **kwargs) -> "StreamingIndex":
        """Wrap an offline-built graph (e.g. build_vamana_graph's output) in
        a mutable index with room to grow."""
        n, dim = vectors.shape
        r = adj.shape[1]
        if capacity < n:
            raise ValueError(f"capacity {capacity} below the built index size {n}")
        ix = cls(capacity, dim, r, dtype=vectors.dtype, **kwargs)
        dev = ix.device
        v = torch.tensor(np.asarray(vectors), device=dev)
        ix.vectors[:n] = v
        ix.norms[:n] = (v.float() ** 2).sum(-1)
        ix.adj[:n] = torch.tensor(np.asarray(adj, np.int32), device=dev)
        ix.degrees[:n] = torch.tensor(np.asarray(degrees, np.int32), device=dev)
        ix.deleted[:n] = False
        ix.medoid = int(medoid)
        ix.hwm = n
        return ix

    @property
    def n_live(self) -> int:
        return self.hwm - len(self.free) - self.n_tombstones

    def _alloc(self, b: int) -> np.ndarray:
        reuse = min(b, len(self.free))
        ids = self.free[:reuse]
        self.free = self.free[reuse:]
        grow = b - reuse
        if self.hwm + grow > self.capacity:
            raise ValueError(
                f"capacity exceeded: {self.hwm}+{grow} > {self.capacity} "
                "(consolidate() frees tombstone slots)"
            )
        ids += list(range(self.hwm, self.hwm + grow))
        self.hwm += grow
        return np.asarray(ids, np.int32)

    def insert(self, batch: np.ndarray) -> np.ndarray:
        """Insert a batch of vectors; returns their assigned ids [B] int32.

        Each chunk is one `_insert_batch` (greedy search over the live graph
        + robust prune + reverse edges) with two streaming additions: the
        chunk's own nearest peers join the candidate pool (a batch landing
        in a small graph must link to its own points), and while the graph
        is smaller than the batch the insert ramps in doubling chunks, so
        that early points see real structure."""
        batch = np.asarray(batch)
        if batch.ndim != 2 or batch.shape[1] != self.dim:
            raise ValueError(f"batch shape {batch.shape}, want [B, {self.dim}]")
        assert_exact_float32()
        out = []
        s = 0
        while s < batch.shape[0]:
            chunk = max(64, self.n_live)  # doubling ramp; one shape at scale
            sub = batch[s : s + chunk]
            out.append(self._insert_chunk(sub))
            s += len(sub)
        return np.concatenate(out) if len(out) > 1 else out[0]

    def _insert_chunk(self, batch: np.ndarray) -> np.ndarray:
        b = batch.shape[0]
        first = self.n_live == 0
        ids_np = self._alloc(b)
        ids = torch.as_tensor(ids_np, device=self.device)
        at = ids.long()
        vecs = torch.as_tensor(batch, device=self.device).to(self.vectors.dtype)
        self.vectors[at] = vecs
        self.norms[at] = (vecs.float() ** 2).sum(-1)
        # recycled slots: scrub the previous tenant's edges so that they
        # cannot leak into the candidate pool
        self.adj[at] = ids[:, None].expand(b, self.r)
        self.degrees[at] = 0
        self.deleted[at] = False
        if first:
            self.medoid = int(ids_np[0])
        peers = _batch_peers(vecs, ids, min(8, max(1, b - 1)))
        _insert_batch(
            self.adj, self.degrees, self.vectors, self.norms, ids, self.medoid,
            r=self.r, alpha=self.alpha, l=self.l_build, max_iters=self.l_build + 16,
            k_overflow=min(self.k_overflow, max(256, b)), max_in=self.r,
            extra_cand=peers,
        )
        return ids_np

    def delete(self, ids: np.ndarray) -> None:
        """Tombstone a batch of ids (lazy: the slots free on consolidate())."""
        ids = np.asarray(ids, np.int32)
        self.deleted[torch.as_tensor(ids, device=self.device).long()] = True
        self.n_tombstones += len(ids)

    def search(self, queries: np.ndarray, params: SearchParams):
        """Returns (ids [Q, k] int32, INVALID_ID padded; dists [Q, k] f32) as
        numpy arrays.

        Tombstones are routed through but filtered from the results; they
        occupy worklist slots, so at a high tombstone fraction raise L or
        consolidate() (FreshDiskANN repairs at ~10-20%)."""
        assert_exact_float32()
        q = torch.as_tensor(np.asarray(queries), device=self.device)
        ids, dists, _ = _search_streaming(
            self.adj, self.vectors, self.deleted, q, self.medoid,
            l=params.L, k=params.k, max_iters=params.max_iters, beam=params.beam_width,
        )
        return ids.cpu().numpy(), dists.cpu().numpy()

    def consolidate(self, batch: int = 512) -> int:
        """Repair the edges into tombstones and free their slots; returns
        the number of rows repaired. The last batch is padded by repeating
        its rows (one shape throughout, as in the JAX package), and the
        repaired counts are read back once, after the loop."""
        assert_exact_float32()
        ns = []
        for s in range(0, self.hwm, batch):
            row_ids = np.arange(s, min(s + batch, self.hwm), dtype=np.int32)
            if len(row_ids) < batch:
                row_ids = np.resize(row_ids, batch)
            ns.append(_repair_batch(
                self.adj, self.degrees, self.vectors, self.norms, self.deleted,
                torch.as_tensor(row_ids, device=self.device), r=self.r, alpha=self.alpha,
            ))
        repaired = int(torch.stack(ns).sum()) if ns else 0
        # free the tombstone slots (nothing points at them now)
        dead = np.flatnonzero(self.deleted[: self.hwm].cpu().numpy())
        in_free = set(self.free)
        freed = [int(i) for i in dead if i not in in_free]
        self.free.extend(freed)
        self.n_tombstones = 0
        if freed and self.medoid in set(freed) and self.n_live > 0:
            self.medoid = _elect_medoid(self.vectors, self.norms, self.deleted)
        return repaired
