"""Exact squared-L2 distance ops.

Port of bang_tpu/ops/l2.py (`squared_norms`, `l2_distance_to_candidates`,
`pack_exact_frontier_rows`, `decode_exact_frontier_rows`): distances for
all (query, candidate) pairs at once via the norm expansion
||v||^2 - 2 q.v + ||q||^2, with the cross term as a batched float32 matmul
(TF32 off, matching the reference's Precision.HIGHEST). Reference kernels
re-designed: the exact `compute_neighborDist_par` variant
(BANG_Exactdistance/parANN.cu:1139-1179) and the re-rank `compute_L2Dist`
(BANG_Base/bang_search.cu:1254-1299).

The fused exact rows are flat only: the JAX package's DMA-tiled form
(`pack_exact_frontier_rows_tiled`, 8-sublane padding) is a TPU layout.
"""

from __future__ import annotations

import torch

from bang_tpu_torch.ops.adjacency import decode_adj_planes, pack_adj_planes


def squared_norms(vectors: torch.Tensor) -> torch.Tensor:
    """[N] f32 squared norms (exact for u8/int8 data: sums stay < 2^24)."""
    v = vectors.float()
    return (v * v).sum(-1)


def l2_distance_to_candidates(
    queries: torch.Tensor,
    cand_vectors: torch.Tensor,
    cand_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Squared L2 of each query to its own candidate rows.

    queries: [Q, D]; cand_vectors: [Q, C, D] (any dtype, cast to f32);
    cand_norms: [Q, C] f32 precomputed ||v||^2, or None to compute here.
    Returns [Q, C] f32, clamped at 0."""
    q = queries.float()
    v = cand_vectors.float()
    if cand_norms is None:
        cand_norms = (v * v).sum(-1)
    cross = torch.bmm(v, q.unsqueeze(-1)).squeeze(-1)  # [Q, C]
    q_norms = (q * q).sum(-1, keepdim=True)
    return torch.clamp_min(cand_norms - 2.0 * cross + q_norms, 0.0)


def pack_exact_frontier_rows(adj: torch.Tensor, vectors: torch.Tensor,
                             norms: torch.Tensor) -> torch.Tensor:
    """Fused exact-frontier rows [B, 8R + R*D] u8 for the adjacency rows
    `adj`, byte-identical to the JAX package's rows.

    Per node, byte-contiguous:
      [ neighbor-id byte-planes 0..3 (R bytes each) |
        neighbor-||v||^2 f32 byte-planes 0..3 (R bytes each) |
        neighbor vectors, row-major R*D u8 ]

    adj: [B, R] int32 (self-padded); vectors: [N, D] u8; norms: [N] f32; all
    on one device. Callers build a large table in row blocks
    (models/index.py), so the [B, R, D] gather stays small."""
    if vectors.dtype != torch.uint8:
        raise ValueError(f"fused exact rows need u8 vectors, got {vectors.dtype}")
    b, r = adj.shape
    ids = adj.long()
    norm_bits = norms[ids].contiguous().view(torch.int32)  # f32 bit pattern
    vecs = vectors[ids].reshape(b, r * vectors.shape[1])
    return torch.cat([pack_adj_planes(adj), pack_adj_planes(norm_bits), vecs], dim=1)


def decode_exact_frontier_rows(rows: torch.Tensor, r: int, d: int):
    """(ids [Q, P*R] i32, norms [Q, P*R] f32, vecs [Q, P*R, D] u8) from
    gathered fused exact rows [Q, P, 8R + R*D] u8."""
    q, p, _ = rows.shape
    ids = decode_adj_planes(rows[..., : 4 * r]).reshape(q, p * r)
    norms = decode_adj_planes(rows[..., 4 * r : 8 * r]).view(torch.float32)
    vecs = rows[..., 8 * r :].reshape(q, p * r, d)
    return ids, norms.reshape(q, p * r), vecs
