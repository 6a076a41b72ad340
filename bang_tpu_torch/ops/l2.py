"""Exact squared-L2 distance ops.

Port of bang_tpu/ops/l2.py (`squared_norms`, `l2_distance_to_candidates`):
distances for all (query, candidate) pairs at once via the norm expansion
||v||^2 - 2 q.v + ||q||^2, with the cross term as a batched float32 matmul
(TF32 off, matching the reference's Precision.HIGHEST). Reference kernels
re-designed: the exact `compute_neighborDist_par` variant
(BANG_Exactdistance/parANN.cu:1139-1179) and the re-rank `compute_L2Dist`
(BANG_Base/bang_search.cu:1254-1299).
"""

from __future__ import annotations

import torch


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
