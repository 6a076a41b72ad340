"""Synthetic data, PQ training and small bundles on the host (numpy), copied
from bang_tpu/formats/synthetic.py.

The same seed gives the same data, codebook, codes and graph as bang_tpu's
functions (tests/test_torch_formats.py holds them equal), so a bundle made
by either package is the same bundle. Copied: `make_clustered_data`,
`medoid_of`, `_dedup_rows_self`, `train_pq` (with `_kmeans` and
`default_chunk_offsets`), `encode_pq`, and `build_synthetic_index` with the
kNN graph and ground truth it builds. The device builders are
`formats/accel.py` and `formats/vamana.py`.
"""

from __future__ import annotations

import os

import numpy as np

from bang_tpu_torch.constants import PQ_NUM_CENTERS
from bang_tpu_torch.formats.bin_io import save_bin, save_truthset
from bang_tpu_torch.formats.graph import GraphIndex, save_graph_index
from bang_tpu_torch.formats.pq import PQData, save_pq


def pairwise_l2sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared L2 distances [len(a), len(b)] via the norm expansion."""
    a = a.astype(np.float32)
    b = b.astype(np.float32)
    aa = (a * a).sum(1)[:, None]
    bb = (b * b).sum(1)[None, :]
    return np.maximum(aa + bb - 2.0 * (a @ b.T), 0.0)


def compute_groundtruth(
    vectors: np.ndarray, queries: np.ndarray, k: int, block: int = 1024
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k (ids, sq-dists) of each query against all vectors."""
    nq = queries.shape[0]
    ids = np.empty((nq, k), dtype=np.uint32)
    dists = np.empty((nq, k), dtype=np.float32)
    for s in range(0, nq, block):
        d = pairwise_l2sq(queries[s : s + block], vectors)
        part = np.argpartition(d, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        ids[s : s + block] = np.take_along_axis(part, order, axis=1)
        dists[s : s + block] = np.take_along_axis(pd, order, axis=1)
    return ids, dists


def medoid_of(vectors: np.ndarray, block: int = 65536) -> int:
    """Index of the vector closest to the dataset mean."""
    mean = vectors.astype(np.float32).mean(0, keepdims=True)
    best_id, best_d = 0, np.inf
    for s in range(0, len(vectors), block):
        d = pairwise_l2sq(vectors[s : s + block], mean)[:, 0]
        i = int(np.argmin(d))
        if d[i] < best_d:
            best_d, best_id = float(d[i]), s + i
    return best_id


def _dedup_rows_self(adj: np.ndarray) -> np.ndarray:
    """Replace within-row duplicate ids by the row's own id (self-padding).

    Adjacency rows must be duplicate-free (DiskANN guarantees it; the
    search's intra-batch dedup relies on it)."""
    n, r = adj.shape
    sorted_idx = np.argsort(adj, axis=1, kind="stable")
    sorted_vals = np.take_along_axis(adj, sorted_idx, axis=1)
    dup_sorted = np.concatenate(
        [np.zeros((n, 1), bool), sorted_vals[:, 1:] == sorted_vals[:, :-1]], axis=1
    )
    dup = np.zeros((n, r), bool)
    np.put_along_axis(dup, sorted_idx, dup_sorted, axis=1)
    self_ids = np.broadcast_to(np.arange(n, dtype=adj.dtype)[:, None], (n, r))
    return np.where(dup, self_ids, adj)


def build_knn_graph(
    vectors: np.ndarray,
    r: int,
    n_random: int = 8,
    seed: int = 0,
    block: int = 2048,
) -> tuple[np.ndarray, np.ndarray]:
    """Navigable graph: (r - n_random) nearest neighbors + n_random random edges.

    Returns (adj [N, r] int32 padded with self id, degrees [N] int32).
    """
    n = vectors.shape[0]
    k_nn = r - n_random
    rng = np.random.default_rng(seed)
    adj = np.empty((n, r), dtype=np.int32)
    for s in range(0, n, block):
        d = pairwise_l2sq(vectors[s : s + block], vectors)
        rows = np.arange(s, min(s + block, n))
        d[np.arange(len(rows)), rows] = np.inf  # exclude self
        part = np.argpartition(d, k_nn - 1, axis=1)[:, :k_nn]
        pd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        adj[s : s + block, :k_nn] = np.take_along_axis(part, order, axis=1)
    if n_random > 0:
        adj[:, k_nn:] = rng.integers(0, n, size=(n, n_random), dtype=np.int32)
        # avoid accidental self-loops in random edges
        self_hit = adj[:, k_nn:] == np.arange(n, dtype=np.int32)[:, None]
        adj[:, k_nn:][self_hit] = (adj[:, k_nn:][self_hit] + 1) % n
    adj = _dedup_rows_self(adj)
    degrees = np.full(n, r, dtype=np.int32)
    return adj, degrees


def _kmeans(
    data: np.ndarray, k: int, iters: int, rng: np.random.Generator
) -> np.ndarray:
    """Plain Lloyd's k-means (random init); returns [k, dim] float32 centers."""
    n = data.shape[0]
    centers = data[rng.choice(n, size=min(k, n), replace=False)].astype(np.float32)
    if len(centers) < k:  # tiny datasets: duplicate
        centers = np.concatenate([centers, centers[rng.integers(0, len(centers), k - len(centers))]])
    for _ in range(iters):
        assign = np.argmin(pairwise_l2sq(data, centers), axis=1)
        sums = np.zeros_like(centers)
        counts = np.zeros(k, dtype=np.int64)
        np.add.at(sums, assign, data.astype(np.float32))
        np.add.at(counts, assign, 1)
        nonempty = counts > 0
        centers[nonempty] = sums[nonempty] / counts[nonempty, None]
        # re-seed empty clusters from random points
        n_empty = int((~nonempty).sum())
        if n_empty:
            centers[~nonempty] = data[rng.integers(0, n, n_empty)].astype(np.float32)
    return centers


def default_chunk_offsets(dim: int, m: int) -> np.ndarray:
    """Even partition of [0, dim) into m chunks (DiskANN-style offsets array)."""
    base = dim // m
    rem = dim % m
    sizes = np.full(m, base, dtype=np.uint32)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.uint32)


def train_pq(
    vectors: np.ndarray,
    m: int,
    kmeans_iters: int = 10,
    sample: int = 65536,
    seed: int = 0,
) -> PQData:
    """Train per-chunk 256-center codebooks on mean-centered data."""
    rng = np.random.default_rng(seed)
    data = vectors.astype(np.float32)
    centroid = data.mean(0)
    offsets = default_chunk_offsets(data.shape[1], m)
    if len(data) > sample:
        train = data[rng.choice(len(data), sample, replace=False)] - centroid
    else:
        train = data - centroid
    pivots = np.zeros((PQ_NUM_CENTERS, data.shape[1]), dtype=np.float32)
    for c in range(m):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        pivots[:, lo:hi] = _kmeans(train[:, lo:hi], PQ_NUM_CENTERS, kmeans_iters, rng)
    return PQData(pivots=pivots, centroid=centroid, chunk_offsets=offsets)


def encode_pq(vectors: np.ndarray, pq: PQData, block: int = 65536) -> np.ndarray:
    """Assign each vector's chunks to nearest codebook centers -> [N, m] uint8."""
    n = vectors.shape[0]
    m = pq.num_chunks
    codes = np.empty((n, m), dtype=np.uint8)
    for s in range(0, n, block):
        chunk_data = vectors[s : s + block].astype(np.float32) - pq.centroid
        for c in range(m):
            lo, hi = int(pq.chunk_offsets[c]), int(pq.chunk_offsets[c + 1])
            d = pairwise_l2sq(chunk_data[:, lo:hi], pq.pivots[:, lo:hi])
            codes[s : s + block, c] = np.argmin(d, axis=1).astype(np.uint8)
    return codes


def make_clustered_data(
    n: int,
    dim: int,
    n_clusters: int = 32,
    dtype=np.float32,
    seed: int = 0,
    intrinsic_dim: int | None = None,
) -> np.ndarray:
    """Clustered data on a low-intrinsic-dimension manifold (SIFT-like).

    Clusters in a latent space of `intrinsic_dim` (default min(dim, 16)),
    mapped to the ambient space by a random linear map, plus small ambient
    noise: neighborhoods keep a smooth distance gradient, where full-dimension
    gaussian clusters would put ~n/n_clusters points into a near-tie shell.
    """
    rng = np.random.default_rng(seed)
    dz = min(dim, 16) if intrinsic_dim is None else intrinsic_dim
    centers = rng.normal(0.0, 1.0, size=(n_clusters, dz)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    z = centers[assign] + rng.normal(0.0, 0.35, size=(n, dz)).astype(np.float32)
    a = rng.normal(0.0, 1.0 / np.sqrt(dz), size=(dz, dim)).astype(np.float32)
    data = z @ a + rng.normal(0.0, 0.02, size=(n, dim)).astype(np.float32)
    dtype = np.dtype(dtype)
    if dtype == np.uint8:
        data = np.clip((data * 28.0) + 128.0, 0, 255).astype(np.uint8)
    elif dtype == np.int8:
        data = np.clip(data * 28.0, -127, 127).astype(np.int8)
    else:
        data = data.astype(dtype)
    return data


def build_synthetic_index(
    prefix: str | os.PathLike,
    n: int = 10000,
    dim: int = 64,
    r: int = 32,
    m: int = 16,
    n_queries: int = 256,
    k: int = 10,
    dtype=np.float32,
    seed: int = 0,
    n_clusters: int = 32,
) -> dict:
    """Build a complete on-disk index bundle (graph + PQ + queries + truthset)
    in the reference's formats: `<prefix>_disk.bin`, `_disk_metadata.bin`,
    `_pq_pivots.bin`, `_pq_compressed.bin`, `_query.bin`, `_gt.bin`."""
    prefix = str(prefix)
    rng = np.random.default_rng(seed + 1)
    data = make_clustered_data(n, dim, n_clusters=n_clusters, dtype=dtype, seed=seed)
    # queries: perturbed data points
    base = data[rng.integers(0, n, n_queries)].astype(np.float32)
    queries = base + rng.normal(0, 0.05 * max(1.0, np.abs(base).mean()), base.shape)
    queries = queries.astype(np.dtype(dtype) if np.dtype(dtype) == np.float32 else np.float32)

    adj, degrees = build_knn_graph(data, r, n_random=max(2, r // 8), seed=seed)
    medoid = medoid_of(data)
    save_graph_index(prefix, GraphIndex(vectors=data, adj=adj, degrees=degrees,
                                        medoid=medoid))

    pq = train_pq(data, m, seed=seed)
    pq.codes = encode_pq(data, pq)
    save_pq(prefix, pq)

    # query files carry the dataset dtype, like the reference's; quantize
    # first so the ground truth matches the stored query values exactly
    dtype = np.dtype(dtype)
    if dtype == np.uint8:
        queries = np.clip(np.rint(queries), 0, 255).astype(np.uint8)
    elif dtype == np.int8:
        queries = np.clip(np.rint(queries), -127, 127).astype(np.int8)
    gt_ids, gt_dists = compute_groundtruth(data, queries.astype(np.float32), k)
    save_bin(prefix + "_query.bin", queries)
    save_truthset(prefix + "_gt.bin", gt_ids, gt_dists)
    return {
        "prefix": prefix,
        "n": n,
        "dim": dim,
        "r": r,
        "m": m,
        "medoid": medoid,
        "n_queries": n_queries,
        "k": k,
    }
