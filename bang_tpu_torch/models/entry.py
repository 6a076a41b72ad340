"""Sampled entry-point selection (port of bang_tpu/models/entry.py).

The reference enters every search at the dataset medoid
(bang_search.cu:466-506, parANN.cu:988-999). With
SearchParams(entry_mode="sampled") each query instead starts at the
nearest points of a strided S-point sample of the dataset, picked by exact
distance with one [Q, S] float32 matmul. "medoid" keeps the reference
behavior.

Ties break as in the JAX package, lowest sample index first: `argmin`
returns the first minimum in both frameworks, and the top-B uses a stable
ascending sort in place of `lax.top_k` (`torch.topk` leaves the order of
ties unspecified; u8 data gives integer distances and frequent ties).
"""

from __future__ import annotations

import torch


def sampled_entry_ids(queries_f32: torch.Tensor, vectors: torch.Tensor,
                      vector_norms: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Per-query entry ids: nearest of a strided S-point sample. [Q] int32.

    The stride makes the sample deterministic and uniform over insertion
    order: no RNG state, nothing stored in the index."""
    return sampled_entry_topb(queries_f32, vectors, vector_norms, n_samples, 1)[0][:, 0]


def sampled_entry_topb(queries_f32: torch.Tensor, vectors: torch.Tensor,
                       vector_norms: torch.Tensor, n_samples: int, b: int):
    """Top-B distinct sampled entries per query with their exact squared-L2
    distances: (ids [Q, B] int32, dists [Q, B] f32). B > 1 seeds every beam
    slot at init. A sample smaller than B (tiny datasets) repeats each
    query's best entry in the remaining slots."""
    n = vectors.shape[0]
    s = int(min(n_samples, n))
    stride = max(1, n // s)
    sample_ids = (torch.arange(s, device=vectors.device) * stride) % n
    sv = vectors[sample_ids].float()  # [S, D]
    sn = vector_norms[sample_ids].float()
    # rank-only squared L2: |v|^2 - 2 q.v; |q|^2 is added back for the dists
    d = sn[None, :] - 2.0 * (queries_f32 @ sv.T)
    qn = (queries_f32 ** 2).sum(-1, keepdim=True)
    if b == 1:
        idx = torch.argmin(d, dim=1, keepdim=True)
    else:
        idx = torch.sort(d, dim=1, stable=True).indices[:, : min(b, s)]
    ids = sample_ids[idx].to(torch.int32)
    dists = d.gather(1, idx) + qn
    if b > idx.shape[1]:
        pad = b - idx.shape[1]
        ids = torch.cat([ids, ids[:, :1].expand(-1, pad)], dim=1)
        dists = torch.cat([dists, dists[:, :1].expand(-1, pad)], dim=1)
    return ids, torch.clamp_min(dists, 0.0)


def entry_points(index, queries_f32: torch.Tensor, params):
    """(entry_ids, entry_dists) for run_traversal from a DeviceIndex and
    SearchParams: the top-beam sampled entries under entry_mode="sampled",
    else (None, None), the shared medoid."""
    if params.entry_mode != "sampled":
        return None, None
    return sampled_entry_topb(queries_f32, index.vectors, index.vector_norms,
                              params.entry_samples, params.beam_width)
