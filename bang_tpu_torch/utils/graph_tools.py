"""Graph diagnostics and warm-up: BFS reachability from the medoid (port of
bang_tpu/utils/graph_tools.py; the BFS is its numpy copy).

The reference picks ~1M nodes by a CPU BFS from the medoid and touches their
PQ codes with a warm-up kernel to heat the GPU's caches (ENABLE_CACHE_WARMUP,
BANG_Exactdistance/parANN.cu:1772-1853). `warmup_touch` does the same: the
BFS on the host, then one gather of the BFS order's codes and vectors on the
device. The BFS doubles as an index sanity check (the reachable fraction
from the medoid bounds the recall a search can reach).
"""

from __future__ import annotations

import numpy as np
import torch

from bang_tpu_torch.ops.adjacency import decode_adj_planes


def bfs_rows(row_fn, n: int, start: int, max_nodes: int | None = None) -> np.ndarray:
    """Breadth-first order of nodes reachable from `start` (≤ max_nodes),
    reading adjacency rows through `row_fn(u) -> iterable of neighbor ids`.
    Level-synchronous with vectorized dedup so mmap-backed graphs stay fast."""
    seen = np.zeros(n, dtype=bool)
    seen[start] = True
    order = [np.asarray([start], dtype=np.int32)]
    frontier = order[0]
    total = 1
    limit = n if max_nodes is None else max_nodes
    while len(frontier) and total < limit:
        nxt = np.unique(np.concatenate([np.asarray(row_fn(int(u)), dtype=np.int64)
                                        for u in frontier]))
        nxt = nxt[(nxt >= 0) & (nxt < n)]
        nxt = nxt[~seen[nxt]]
        if len(nxt) == 0:
            break
        if total + len(nxt) > limit:
            nxt = nxt[: limit - total]
        seen[nxt] = True
        frontier = nxt.astype(np.int32)
        order.append(frontier)
        total += len(frontier)
    return np.concatenate(order)


def bfs_from(adj: np.ndarray, start: int, max_nodes: int | None = None) -> np.ndarray:
    """Breadth-first order of nodes reachable from `start` (≤ max_nodes)."""
    return bfs_rows(lambda u: adj[u], adj.shape[0], start, max_nodes)


def reachable_fraction(adj: np.ndarray, medoid: int, sample_cap: int = 2_000_000) -> float:
    """Fraction of (up to sample_cap) nodes reachable from the medoid."""
    order = bfs_from(adj, medoid, max_nodes=sample_cap)
    return len(order) / min(adj.shape[0], sample_cap)


def _mmap_row_fn(searcher):
    """Adjacency-row accessor over a BaseVariantSearcher's packed host graph
    (record layout: [vector | degree u32 | nbrs u32*R], formats/graph.py)."""
    vec_nbytes = searcher.vec_bytes
    r = searcher.meta.degree

    def row_fn(u):
        rec = np.asarray(searcher.raw[u])
        deg = int(rec[vec_nbytes : vec_nbytes + 4].view("<u4")[0])
        return rec[vec_nbytes + 4 :].view("<u4")[: min(deg, r)]

    return row_fn


def device_adjacency(index) -> np.ndarray | None:
    """The [N, R] int32 adjacency of a DeviceIndex on the host: `adj` when
    the layout has one, else the id byte-planes of its fused rows (the first
    4R bytes of each PQ row, ops/pq_kernels.pack_frontier_rows, or of each
    exact row, ops/l2.pack_exact_frontier_rows), sliced on the device so
    that only [N, 4R] bytes cross to the host, and decoded there. None for
    an object without a device graph (base)."""
    if getattr(index, "adj", None) is not None:
        return index.adj.cpu().numpy()
    rows = getattr(index, "fused_rows", None)
    if rows is not None:
        r = rows.shape[1] // (4 + index.codes.shape[1])
    else:
        rows = getattr(index, "fused_vec_rows", None)
        if rows is None:
            return None
        r = rows.shape[1] // (8 + index.dim)
    planes = rows[:, : 4 * r].cpu()
    return decode_adj_planes(planes).numpy()


def warmup_touch(index, n_nodes: int = 1_000_000) -> int:
    """ENABLE_CACHE_WARMUP: BFS-discover up to `n_nodes` nodes from the
    medoid and touch their device-resident PQ codes and vectors once (one
    gather each, waited for). `index` is a DeviceIndex (the BFS walks its
    adjacency, decoded from the fused rows when there is no table) or a
    BaseVariantSearcher (the BFS walks the packed records in host RAM, as
    the reference's CPU BFS does). Returns the number of nodes touched: the
    BFS count, or 0 when the object has neither a graph nor device arrays."""
    adj = device_adjacency(index)
    if adj is not None:
        order = bfs_from(adj, index.medoid, max_nodes=n_nodes)
    elif getattr(index, "raw", None) is not None:
        order = bfs_rows(_mmap_row_fn(index), index.meta.n, index.meta.medoid,
                         max_nodes=n_nodes)
    else:
        return 0
    touched = 0
    ids = None
    for arr in (getattr(index, "codes", None), getattr(index, "vectors", None)):
        if arr is not None:
            if ids is None:
                ids = torch.as_tensor(order, device=arr.device).long()
            arr[ids].sum().item()  # the gather, waited for
            touched = len(order)
    return touched
