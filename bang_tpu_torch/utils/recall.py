"""Recall with distance-tie expansion of the gold set, copied from
bang_tpu/utils/recall.py.

Behavioral parity with the reference's `calculate_recall`
(BANG_Base/test_driver.cpp:43-93): when ground-truth distances are given,
the gold set grows past `recall_at` while the distance ties the k-th entry,
and recall is |gold ∩ returned@k| / k averaged over queries, in percent.
"""

from __future__ import annotations

import numpy as np


def calculate_recall(
    gt_ids: np.ndarray,
    result_ids: np.ndarray,
    recall_at: int,
    gt_dists: np.ndarray | None = None,
) -> float:
    """Percent recall@`recall_at` of `result_ids` against the ground truth.

    gt_ids: [Q, dim_gs] gold ids; gt_dists: matching distances or None;
    result_ids: [Q, >=recall_at] returned ids.
    """
    nq, dim_gs = gt_ids.shape
    total = 0
    for i in range(nq):
        tie_breaker = recall_at
        if gt_dists is not None:
            tie_breaker = recall_at - 1
            row = gt_dists[i]
            while tie_breaker < dim_gs and row[tie_breaker] == row[recall_at - 1]:
                tie_breaker += 1
        gold = set(int(x) for x in gt_ids[i, :tie_breaker])
        res = set(int(x) for x in result_ids[i, :recall_at])
        total += len(gold & res)
    return total / nq * (100.0 / recall_at)
