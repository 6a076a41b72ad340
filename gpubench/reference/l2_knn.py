"""Exact k nearest neighbors under squared L2, and the comparison that
decides `correct` for an approximate search.

`exact_knn` is brute force by the norm expansion: for u8 vectors in float32
with TF32 off, where every product, every partial sum and every norm is an
integer below 2^24 (128 x 255^2 = 8,323,200; twice that is 16,646,400), so
each distance is exact whatever the summation order; for float vectors in
float64. `true_distances` recomputes the distance of each returned id from
the vectors, in int32 for integer vectors and float64 for float ones.

`Judge` holds a run's answers to two numbers:
  recall    tie-expanded recall@k in percent over every answered query (a
            frozen copy of the arithmetic of the program's
            utils/recall.calculate_recall: the gold set grows past k while
            the distance ties the k-th);
  dist_gap  the largest |returned distance - true distance of the
            returned id| / max(true distance, 1) over every returned slot;
            an id outside [0, N) reads inf.
`Judge.correct(cfg)` is the decision itself: recall at or above the
config's `recall_limit` and dist_gap at or below its `dist_gap_limit`,
over at least one answer.
`exact_knn(..., precision=...)` runs the same brute force in a lower
precision: the control, put in the program's place (tools/calibrate.py
control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

GOLD = 64  # neighbors kept a query: the tie expansion past k reads these


def _matmul_dtype(precision: str):
    return {"float64": torch.float64, "float32": torch.float32, "tf32": torch.float32,
            "bfloat16": torch.bfloat16, "float16": torch.float16}[precision]


def exact_knn(base: torch.Tensor, queries: torch.Tensor, k: int,
              precision: str | None = None, block: int = 1024):
    """(ids [Q, k] int64, dists [Q, k] float32) of the k nearest base rows of
    each query, ascending. base [N, D] and queries [Q, D] are tensors of one
    dtype on one device. precision None is exact: "float32" for u8 data,
    "float64" for float data; "tf32", "bfloat16" and "float16" compute in
    that precision (the control)."""
    if precision is None:
        precision = "float64" if base.dtype.is_floating_point else "float32"
    dt = _matmul_dtype(precision)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        acc = torch.float64 if dt == torch.float64 else torch.float32  # norms and ranks
        x = base.to(dt)
        xn = (x.to(acc) * x.to(acc)).sum(1).to(dt)
        ids, dists = [], []
        for s in range(0, queries.shape[0], block):
            q = queries[s : s + block].to(dt)
            qn = (q.to(acc) * q.to(acc)).sum(1).to(dt)
            d = qn[:, None] + xn[None, :] - 2 * (q @ x.T)
            dv, di = torch.topk(d.to(acc), k, dim=1, largest=False, sorted=True)
            ids.append(di)
            dists.append(dv.float().clamp_min(0))
        return torch.cat(ids), torch.cat(dists)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def true_distances(base: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
                   block: int = 4096) -> torch.Tensor:
    """Exact squared L2 [Q, k] float64 of each query to each of its ids (int32
    arithmetic for integer vectors, float64 for float ones); an id outside
    [0, N) gives inf."""
    n = base.shape[0]
    out = torch.empty(ids.shape, dtype=torch.float64, device=ids.device)
    for s in range(0, ids.shape[0], block):
        i = ids[s : s + block]
        ok = (i >= 0) & (i < n)
        wide = torch.float64 if base.dtype.is_floating_point else torch.int32
        rows = base[i.clamp(0, n - 1)].to(wide)  # [B, k, D]
        diff = rows - queries[s : s + block, None, :].to(wide)
        d = (diff * diff).sum(-1).double()
        out[s : s + block] = torch.where(ok, d, torch.full_like(d, math.inf))
    return out


def recall_hits(gold_ids: torch.Tensor, gold_d: torch.Tensor, res: torch.Tensor,
                k: int) -> tuple[torch.Tensor, int]:
    """(hits [Q] of the first k distinct returned ids in the tie-expanded
    gold set, queries whose ties run past the kept GOLD columns). The gold
    set of a query is its first columns whose distance equals or is below
    the k-th (the columns ascend): calculate_recall's tie_breaker loop."""
    res = res[:, :k]
    gold_mask = gold_d <= gold_d[:, k - 1 : k]
    clipped = int(gold_mask[:, -1].sum()) if gold_d.shape[1] > k else 0
    hit = ((res[:, :, None] == gold_ids[:, None, :]) & gold_mask[:, None, :]).any(-1)
    earlier = torch.triu(torch.ones(k, k, dtype=torch.bool, device=res.device), 1)
    dup = ((res[:, :, None] == res[:, None, :]) & earlier[None]).any(1)  # [Q, k]
    return (hit & ~dup).sum(1), clipped


class Judge:
    """Accumulates the answers of a run, then gives the two numbers.

    base, queries: the corpus and the query pool, on the device the
    comparison runs on; gold_ids, gold_d: exact_knn's [pool, GOLD] answer.
    `add(pool_idx, ids, dists)` takes one request's answer: the pool rows it
    asked for and the program's ids [B, >=k] and distances."""

    def __init__(self, base, queries, gold_ids, gold_d, k: int):
        self.base, self.queries = base, queries
        self.gold_ids, self.gold_d, self.k = gold_ids, gold_d, k
        self.hits = 0
        self.answered = 0
        self.gap = 0.0
        self.clipped = 0

    def add(self, pool_idx, ids, dists) -> None:
        dev = self.base.device
        idx = torch.as_tensor(np.asarray(pool_idx), device=dev).long()
        ids = torch.as_tensor(np.asarray(ids), device=dev).long()[:, : self.k]
        dists = torch.as_tensor(np.asarray(dists), device=dev).double()[:, : self.k]
        if ids.shape[0] != idx.shape[0]:
            raise ValueError(f"{ids.shape[0]} answers for {idx.shape[0]} queries")
        hits, clipped = recall_hits(self.gold_ids[idx], self.gold_d[idx], ids, self.k)
        self.hits += int(hits.sum())
        self.clipped += clipped
        self.answered += idx.shape[0]
        true = true_distances(self.base, self.queries[idx], ids)
        gap = (dists - true).abs() / true.clamp_min(1.0)
        gap = torch.where(torch.isfinite(true) & torch.isfinite(dists), gap,
                          torch.full_like(gap, math.inf))
        self.gap = max(self.gap, float(gap.max()) if gap.numel() else 0.0)

    def recall(self) -> float:
        return 100.0 * self.hits / (self.answered * self.k) if self.answered else 0.0

    def checks(self, cfg: dict) -> dict:
        """Each number judged, beside its limit from the config."""
        return {"recall": {"value": self.recall(), "limit": cfg["recall_limit"]},
                "dist_gap": {"value": self.gap, "limit": cfg["dist_gap_limit"]}}

    def correct(self, cfg: dict) -> bool:
        return (self.answered > 0 and self.recall() >= cfg["recall_limit"]
                and self.gap <= cfg["dist_gap_limit"])
