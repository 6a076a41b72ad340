"""Vamana graph construction on the device, in batches (port of
bang_tpu/formats/vamana.py).

The reference relies on DiskANN's `build_disk_index` for its graphs
(README.md:42-58); this is the self-contained equivalent the bench builds
its bundles with: a batched Vamana builder in the DiskANN style (greedy
search for candidates + alpha robust prune + reverse-edge insertion).

Algorithm (standard Vamana):
  1. start from a random (R/2)-regular graph (slack absorbs reverse edges);
  2. for each point p (in batches): greedy-search p from the medoid over the
     current graph with the exact-distance traversal, collect the visited
     set V;
  3. adj[p] = RobustPrune(p, V + adj[p], alpha, R) — greedily keep the
     nearest candidate c, discard every candidate c' with
     alpha * d(c, c') <= d(p, c');
  4. for each kept edge (p -> c): append the reverse edge c -> p into c's
     degree slack; targets that overflow R get a re-prune (capped at
     k_overflow targets per batch; excess reverse edges are dropped and
     counted);
  5. run n_passes passes (alpha = 1.0 for all but the last).

The numpy generator from `seed` draws the start graph and the per-pass
shuffles in the JAX package's order, so both insert the same batches; with
u8 data every distance is an exact integer in f32 and the two build the
same graph.

Port notes. The JAX scatters with mode="drop" send dropped writes to an
out-of-range index; PyTorch raises there (a CUDA device asserts). The port
gives the adjacency and the degrees one extra trash row at index N, which
no edge points to and no search reads, and aims dropped writes at it: every
step keeps its fixed shape, and the host reads the device only at the
heartbeat, every 100 batches (plus the traversal's one `active.any()` read
per iteration, ROADMAP Queue 1 item 13). `jnp.unique(size=, fill_value=)`
becomes a sort, a first-occurrence mask and a scatter into a buffer
pre-filled with N; `lax.associative_scan(maximum)` becomes `torch.cummax`;
`jnp.argsort` and `jnp.sort` are stable, as `torch.argsort(stable=True)`.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from bang_tpu.formats.synthetic import medoid_of
from bang_tpu_torch.device import assert_exact_float32, resolve_device
from bang_tpu_torch.formats.accel import _robust_prune_batch
from bang_tpu_torch.models.index import squared_norms_host
from bang_tpu_torch.models.traversal import make_exact_distance_fn, run_traversal
from bang_tpu_torch.ops.l2 import l2_distance_to_candidates, squared_norms


def _prune_ids(vectors, norms, p_ids, cand, r: int, alpha: float):
    """Robust prune of a raw candidate id list (duplicates, self and
    negative ids tolerated). Returns (rows [B, r] int32 self-padded,
    degrees [B] int32)."""
    # row-sort ids; mask duplicates (adjacent after sort), self, and padding
    cs = torch.sort(cand, dim=1).values
    dup = torch.cat([torch.zeros_like(cs[:, :1], dtype=torch.bool),
                     cs[:, 1:] == cs[:, :-1]], dim=1)
    valid = (cs >= 0) & (cs != p_ids[:, None]) & ~dup
    safe = cs.clamp_min(0).long()
    p_vecs = vectors[p_ids.long()].float()
    cand_vecs = vectors[safe].float()
    cand_d = l2_distance_to_candidates(p_vecs, cand_vecs, norms[safe])
    cand_d = torch.where(valid, cand_d, torch.full_like(cand_d, float("inf")))
    sel_idx, sel_valid = _robust_prune_batch(cand_vecs, cand_d, valid, r, alpha)
    rows = torch.where(sel_valid, safe.gather(1, sel_idx.clamp_min(0)),
                       p_ids[:, None].long()).to(torch.int32)
    return rows, sel_valid.sum(dim=1).to(torch.int32)


def _unique_padded(x, size: int, fill: int):
    """Sorted distinct values of 1-d `x`, padded with `fill` and cut to
    `size` (jnp.unique(x, size=size, fill_value=fill)), in fixed shapes."""
    xs = torch.sort(x).values
    first = torch.ones_like(xs, dtype=torch.bool)
    first[1:] = xs[1:] != xs[:-1]
    slot = torch.cumsum(first, 0) - 1
    m = xs.shape[0]
    out = torch.full((max(m, size) + 1,), fill, dtype=x.dtype, device=x.device)
    out[torch.where(first, slot, torch.full_like(slot, out.shape[0] - 1))] = xs
    out[-1] = fill
    return out[:size]


def _insert_batch(adj, degrees, vectors, norms, p_ids, medoid: int, r: int,
                  alpha: float, l: int, max_iters: int, k_overflow: int,
                  max_in: int):
    """Insert a batch of points: search + prune + scatter + reverse edges.
    adj [N+1, r] and degrees [N+1] (row N is the trash row) are updated in
    place. Returns the count of dropped reverse edges (device scalar)."""
    n = adj.shape[0] - 1
    b = p_ids.shape[0]
    dev = adj.device
    p = p_ids.long()
    dist_fn = make_exact_distance_fn(vectors[p].float(), vectors)
    final = run_traversal(adj, dist_fn, medoid, b, l, max_iters, 1, dev)

    # Vamana candidate pool: the visited set of the greedy search + old edges
    cand = torch.cat([final.visited_ids, adj[p]], dim=1)
    new_rows, new_deg = _prune_ids(vectors, norms, p_ids, cand, r, alpha)
    adj[p] = new_rows
    degrees[p] = new_deg

    # ---- reverse edges (p -> c becomes c -> p) ----
    src = p_ids.repeat_interleave(r)  # [B*r]
    dst = new_rows.reshape(-1)
    valid = dst != src  # self-padding rows produce dst == src
    # skip targets that already list src (would waste a slot forever)
    valid &= ~(adj[dst.long()] == src[:, None]).any(dim=1)
    trash = torch.full_like(dst, n)
    key = torch.where(valid, dst, trash)  # invalid edges sort to the end
    order = torch.argsort(key, stable=True)
    dsts = key[order]
    srcs = src[order]
    edge_valid = dsts < n
    pos = torch.arange(b * r, dtype=torch.int32, device=dev)
    isnew = torch.ones_like(edge_valid)
    isnew[1:] = dsts[1:] != dsts[:-1]
    first = torch.cummax(torch.where(isnew, pos, torch.zeros_like(pos)), 0).values
    slot = degrees[dsts.clamp_max(n - 1).long()] + (pos - first)  # rank in dst group
    fits = edge_valid & (slot < r)
    # (dst, slot) pairs are unique within the batch: conflict-free scatter
    at = torch.where(fits, dsts, trash).long()
    adj[at, slot.clamp(0, r - 1).long()] = srcs
    degrees.index_put_((at,), torch.ones_like(degrees[at]), accumulate=True)

    # ---- overflowing targets: re-prune current edges + incoming ----
    ovf = edge_valid & (slot >= r)
    ovf_ids = _unique_padded(torch.where(ovf, dsts, trash), k_overflow, n)
    row = torch.searchsorted(ovf_ids, dsts).clamp_max(k_overflow - 1)
    col = slot - r
    # guard: the edge's dst actually made it into the capped unique set
    inc_ok = ovf & (ovf_ids[row] == dsts) & (col < max_in)
    inc = torch.full((k_overflow + 1, max_in), -1, dtype=torch.int32, device=dev)
    inc[torch.where(inc_ok, row, torch.full_like(row, k_overflow)),
        col.clamp(0, max_in - 1).long()] = srcs
    t_valid = ovf_ids < n
    safe_t = ovf_ids.clamp_max(n - 1)
    cand_t = torch.cat([adj[safe_t.long()], inc[:k_overflow]], dim=1)  # [K, r+max_in]
    t_rows, t_deg = _prune_ids(vectors, norms, safe_t, cand_t, r, alpha)
    at_t = torch.where(t_valid, ovf_ids, torch.full_like(ovf_ids, n)).long()
    adj[at_t] = t_rows
    degrees[at_t] = t_deg
    return (ovf & ~inc_ok).sum()


def build_vamana_graph(
    vectors,
    r: int,
    device,
    l_build: int = 48,
    alpha: float = 1.44,  # on SQUARED distances; == DiskANN's 1.2 on plain
    batch: int = 1024,
    seed: int = 0,
    n_passes: int = 2,
    k_overflow: int | None = None,
    verbose: bool = True,
    medoid: int | None = None,
    return_device: bool = False,
    init: tuple[np.ndarray, np.ndarray] | None = None,
):
    """Build a Vamana graph on `device`. Returns (adj [N, r] int32
    self-padded, degrees [N] int32, medoid), the contract of the JAX
    `build_vamana_graph`.

    vectors: host numpy array or a tensor already on `device` (then pass
    `medoid`). return_device=True returns the device tensors and skips the
    download. init=(adj0, deg0) warm-starts from an existing graph
    (DiskANN-style incremental build, degree upgrades allowed): rows must
    list real edges first; slots at or past the degree become
    self-padding."""
    assert_exact_float32()
    dev = resolve_device(device)
    is_device = isinstance(vectors, torch.Tensor)
    if medoid is None:
        if is_device:
            raise ValueError("pass medoid= explicitly for device-resident vectors")
        medoid = medoid_of(vectors)

    n = vectors.shape[0]
    rng = np.random.default_rng(seed)
    self_ids = np.arange(n, dtype=np.int32)[:, None]
    adj = np.broadcast_to(self_ids, (n, r)).copy()
    if init is not None:
        adj0, deg0 = init
        r_in = adj0.shape[1]
        if r_in > r:
            raise ValueError(f"init degree {r_in} exceeds target r={r}")
        adj[:, :r_in] = adj0
        degrees = np.minimum(deg0.astype(np.int32), r_in)
        # slots >= degree become self-padding (packed _disk.bin rows are
        # zero-padded: those zeros would add spurious edges to node 0)
        pad = np.arange(r, dtype=np.int32)[None, :] >= degrees[:, None]
        np.copyto(adj, np.broadcast_to(self_ids, (n, r)), where=pad)
    else:
        # start at half degree: the slack absorbs reverse-edge appends so
        # that only overflowing nodes need a re-prune (DiskANN's scheme)
        r0 = max(1, r // 2)
        adj[:, :r0] = rng.integers(0, n, size=(n, r0), dtype=np.int32)
        self_hit = adj[:, :r0] == self_ids
        adj[:, :r0][self_hit] = (adj[:, :r0][self_hit] + 1) % n
        degrees = np.full(n, r0, np.int32)

    # one trash row at index n takes the writes the JAX scatters drop
    adj_dev = torch.empty((n + 1, r), dtype=torch.int32, device=dev)
    adj_dev[:n] = torch.as_tensor(adj, device=dev)
    adj_dev[n] = n
    deg_dev = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    deg_dev[:n] = torch.as_tensor(degrees, device=dev)
    del adj, degrees
    if is_device:
        vec_dev = vectors
        norms_dev = squared_norms(vectors)
    else:
        vec_dev = torch.as_tensor(vectors, device=dev)
        norms_dev = torch.as_tensor(squared_norms_host(vectors), device=dev)

    batch = min(batch, max(256, n))
    if k_overflow is None:
        k_overflow = max(512, batch)
    max_in = r
    max_iters = l_build + 16

    alphas = [1.0] * (n_passes - 1) + [float(alpha)]
    t_start = time.time()
    order = np.arange(n)
    for pass_i, a in enumerate(alphas):
        rng.shuffle(order)
        n_batches = -(-n // batch)
        for bi, s in enumerate(range(0, n, batch)):
            p_ids = order[s : s + batch]
            if len(p_ids) < batch:  # keep one batch shape
                # pad with OTHER ids from the shuffled order (cycling the
                # short remainder would re-insert the same points several
                # times in one batch: each copy gets a distinct reverse-edge
                # slot, permanently eating degree slack). Distinct whenever
                # batch <= n; wraps only for datasets smaller than a batch.
                p_ids = np.resize(order, s + batch)[s : s + batch]
            dropped = _insert_batch(
                adj_dev, deg_dev, vec_dev, norms_dev,
                torch.as_tensor(p_ids.astype(np.int32), device=dev), medoid,
                r=r, alpha=a, l=l_build, max_iters=max_iters,
                k_overflow=k_overflow, max_in=max_in,
            )
            if verbose and bi % 100 == 0:
                # the scalar read is the builder's only sync (heartbeat)
                print(
                    f"[vamana] pass {pass_i} batch {bi}/{n_batches} "
                    f"dropped_rev={int(dropped)} t={time.time() - t_start:.0f}s",
                    file=sys.stderr, flush=True,
                )
    if verbose:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"[vamana] built n={n} r={r} in {time.time() - t_start:.0f}s",
              file=sys.stderr, flush=True)
    if return_device:
        return adj_dev[:n], deg_dev[:n], medoid
    return adj_dev[:n].cpu().numpy(), deg_dev[:n].cpu().numpy(), medoid
