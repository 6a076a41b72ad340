"""Offline index construction on the device: exact ground truth, the kNN
and alpha-pruned kNN graphs and PQ encoding (port of the builders a bench
bundle needs from bang_tpu/formats/accel.py, with `_robust_prune_batch`
from bang_tpu/formats/vamana.py; the Vamana builder is formats/vamana.py).

Blocked float32 matmuls (TF32 off) plus a top-k whose distance ties break
lowest index first, like `lax.top_k`: u8 data gives integer distances and
frequent ties, and `torch.topk` leaves their order unspecified. Output
contracts are those of the JAX functions. PQ training stays on the host:
the port's numpy copy `formats/synthetic.train_pq`.
"""

from __future__ import annotations

import numpy as np
import torch

from bang_tpu_torch.device import assert_exact_float32, resolve_device
from bang_tpu_torch.formats.synthetic import _dedup_rows_self
from bang_tpu_torch.ops.l2 import squared_norms
from bang_tpu_torch.ops.pq import prepare_pq_codebook


def _topk_smallest(d: torch.Tensor, k: int):
    """(ids [B, k] int64, dists [B, k]) of the k smallest entries per row,
    ascending, ties broken by the lower column index."""
    kth = torch.topk(d, k, dim=1, largest=False, sorted=True).values[:, -1:]
    below = d < kth
    tied = d == kth
    need = k - below.sum(1, keepdim=True)  # >= 1 tied slots to fill
    take = below | (tied & (torch.cumsum(tied, dim=1, dtype=torch.int32) <= need))
    ids = take.nonzero()[:, 1].reshape(d.shape[0], k)  # row-major, ascending
    vals = d.gather(1, ids)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return ids.gather(1, order), vals


def _block_topk(blk, vectors, vector_norms, k):
    """Top-k nearest (ids, squared dists) of the rows of `blk` against all
    `vectors` — the norm expansion, as the JAX `_block_topk`."""
    b = blk.float()
    cross = b @ vectors.T
    d = vector_norms[None, :] - 2.0 * cross + (b * b).sum(-1, keepdim=True)
    return _topk_smallest(d, k)


def compute_groundtruth(
    vectors: np.ndarray, queries: np.ndarray, k: int, device, block: int = 512
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k ground truth (ids [Q, k] uint32, squared dists [Q, k] f32)."""
    assert_exact_float32()
    dev = resolve_device(device)
    v = torch.as_tensor(vectors, device=dev).float()
    norms = squared_norms(v)
    nq = queries.shape[0]
    ids = np.empty((nq, k), np.uint32)
    dists = np.empty((nq, k), np.float32)
    for s in range(0, nq, block):
        q_blk = torch.as_tensor(queries[s : s + block], device=dev)
        i, dd = _block_topk(q_blk, v, norms, k)
        ids[s : s + block] = i.cpu().numpy().astype(np.uint32)
        dists[s : s + block] = dd.cpu().numpy()
    return ids, dists


def _robust_prune_batch(cand_vecs, cand_dists, cand_valid, r: int, alpha: float):
    """Batched alpha-RNG robust prune (the Vamana occlusion rule).

    cand_vecs: [B, C, D] f32; cand_dists: [B, C] squared L2 to p;
    cand_valid: [B, C] bool. Greedily keeps the nearest alive candidate and
    drops every candidate c' with alpha * d(pick, c') <= d(p, c'). Returns
    (sel_idx [B, r] int64 positions into the candidate axis, -1 where none
    is left; sel_valid [B, r] bool). The JAX version also takes the points
    themselves, which it never reads: their distances come in as cand_dists."""
    b, c, _ = cand_vecs.shape
    dev = cand_vecs.device
    alive = cand_valid.clone()
    iota = torch.arange(c, device=dev)[None, :]
    sel_idx = torch.full((b, r), -1, dtype=torch.int64, device=dev)
    sel_valid = torch.zeros((b, r), dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for i in range(r):
        pick = torch.argmin(torch.where(alive, cand_dists, inf), dim=1)  # first min
        valid = alive.gather(1, pick[:, None])[:, 0]
        sel_idx[:, i] = torch.where(valid, pick, torch.full_like(pick, -1))
        sel_valid[:, i] = valid
        pick_vec = cand_vecs[torch.arange(b, device=dev), pick]  # [B, D]
        d_cc = ((cand_vecs - pick_vec[:, None, :]) ** 2).sum(-1)  # [B, C]
        occluded = alpha * d_cc <= cand_dists
        alive = alive & ~occluded & (iota != pick[:, None])
    return sel_idx, sel_valid


def _random_edges(adj: np.ndarray, k_keep: int, n_random: int, seed: int) -> np.ndarray:
    """Fill columns k_keep.. with random non-self edges (numpy generator
    from `seed`, as in the JAX builders), then self-pad duplicates."""
    n = adj.shape[0]
    if n_random > 0:
        rng = np.random.default_rng(seed)
        adj[:, k_keep:] = rng.integers(0, n, size=(n, n_random), dtype=np.int32)
        self_hit = adj[:, k_keep:] == np.arange(n, dtype=np.int32)[:, None]
        adj[:, k_keep:][self_hit] = (adj[:, k_keep:][self_hit] + 1) % n
    return _dedup_rows_self(adj)


def _drop_self(ids, dists, rows, k):
    """The first k columns of a top-k block after moving the row's own id
    to the back (stable, so the other columns keep their order)."""
    order = torch.sort((ids == rows[:, None]).to(torch.int8), dim=1,
                       stable=True).indices[:, :k]
    return ids.gather(1, order), dists.gather(1, order)


def build_knn_graph(
    vectors: np.ndarray,
    r: int,
    device,
    n_random: int = 8,
    seed: int = 0,
    block: int = 1024,
) -> tuple[np.ndarray, np.ndarray]:
    """kNN + random-edge navigable graph: (adj [N, r] int32 self-padded,
    degrees [N] int32), the contract of the JAX `build_knn_graph_jax`.

    Per node: the r - n_random nearest neighbors plus n_random random
    edges."""
    assert_exact_float32()
    dev = resolve_device(device)
    n = vectors.shape[0]
    k_nn = r - n_random
    v = torch.as_tensor(vectors, device=dev).float()
    norms = squared_norms(v)
    adj = np.empty((n, r), dtype=np.int32)
    for s in range(0, n, block):
        blk = v[s : s + block]
        ids, dists = _block_topk(blk, v, norms, k_nn + 1)
        rows = torch.arange(s, s + blk.shape[0], device=dev)
        adj[s : s + block, :k_nn] = _drop_self(ids, dists, rows, k_nn)[0].cpu().numpy()
    return _random_edges(adj, k_nn, n_random, seed), np.full(n, r, dtype=np.int32)


def build_pruned_knn_graph(
    vectors: np.ndarray,
    r: int,
    device,
    k_base_factor: int = 3,
    alpha: float = 1.2,
    n_random: int = 4,
    seed: int = 0,
    block: int = 1024,
) -> tuple[np.ndarray, np.ndarray]:
    """Diversified (alpha-pruned) kNN graph: (adj [N, r] int32 self-padded,
    degrees [N] int32), the contract of the JAX
    `build_pruned_knn_graph_jax`.

    Per node: the k_base_factor*r nearest neighbors, robust-pruned to
    r - n_random diverse edges, plus n_random random edges (numpy generator
    from `seed`, as in the JAX version) for global connectivity."""
    assert_exact_float32()
    dev = resolve_device(device)
    n = vectors.shape[0]
    k_keep = r - n_random
    k_base = min(n - 1, k_base_factor * r)
    v = torch.as_tensor(vectors, device=dev).float()
    norms = squared_norms(v)
    adj = np.empty((n, r), dtype=np.int32)
    for s in range(0, n, block):
        blk = v[s : s + block]
        nb = blk.shape[0]
        ids, dists = _block_topk(blk, v, norms, k_base + 1)
        rows = torch.arange(s, s + nb, device=dev)
        cand_ids, cand_dists = _drop_self(ids, dists, rows, k_base)
        sel_idx, sel_valid = _robust_prune_batch(
            v[cand_ids], cand_dists,
            torch.ones_like(cand_dists, dtype=torch.bool), k_keep, alpha,
        )
        picked = cand_ids.gather(1, sel_idx.clamp_min(0))
        adj[s : s + nb, :k_keep] = torch.where(
            sel_valid, picked, rows[:, None]
        ).cpu().numpy()
    return _random_edges(adj, k_keep, n_random, seed), np.full(n, r, dtype=np.int32)


def _encode_block(chunk_data: torch.Tensor, piv_chunks: torch.Tensor) -> torch.Tensor:
    """chunk_data [B, m, dmax] f32 (centered, zero-padded per chunk);
    piv_chunks [m, 256, dmax] -> codes [B, m] u8, the nearest center per
    chunk (first on ties), by the norm expansion (the JAX `_encode_block`)."""
    d = (
        (piv_chunks * piv_chunks).sum(-1)[None]
        - 2.0 * torch.einsum("bmt,mjt->bmj", chunk_data, piv_chunks)
        + (chunk_data * chunk_data).sum(-1)[:, :, None]
    )
    return torch.argmin(d, dim=-1).to(torch.uint8)


def encode_pq(vectors: np.ndarray, pq, device, block: int = 65536) -> np.ndarray:
    """PQ-encode all vectors: codes [N, m] uint8 (nearest center per chunk),
    the contract of `synthetic.encode_pq` / the JAX `encode_pq_jax`."""
    assert_exact_float32()
    dev = resolve_device(device)
    cb = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets, dev)
    dim_idx = cb.dim_idx.cpu().numpy()
    dim_mask = cb.dim_mask.cpu().numpy()
    n = vectors.shape[0]
    codes = np.empty((n, cb.num_chunks), np.uint8)
    for s in range(0, n, block):
        x = vectors[s : s + block].astype(np.float32) - pq.centroid
        chunk_data = torch.as_tensor(x[:, dim_idx] * dim_mask, device=dev)
        codes[s : s + block] = _encode_block(chunk_data, cb.piv_chunks).cpu().numpy()
    return codes
