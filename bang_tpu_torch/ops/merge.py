"""Worklist (best-L set) maintenance: sorted merge and parent selection.

Port of bang_tpu/ops/merge.py (`init_worklist`, `merge_worklist`,
`select_parents_beam`), the re-design of the reference's
`compute_BestLSets_par_sort_msort` + `compute_BestLSets_par_merge` +
`compute_parent1/2` (BANG_Base/bang_search.cu:1384-1715).

`merge_worklist` is one stable `torch.sort` of concat(worklist, candidates)
by distance — the same concat order as the JAX `lax.sort`, so distance ties
keep worklist entries first and results are bit-identical. The JAX
package's merge-path variant `merge_worklist_ranked` exists only because a
TPU sort is a bitonic network; it is not ported (ROADMAP Queue 1 item 3).

Empty slots carry id INVALID_ID, distance +inf, visited=True, so they sort
to the tail and are never selected.
"""

from __future__ import annotations

import torch

from bang_tpu.constants import INVALID_ID


def init_worklist(q: int, l: int, device):
    """Empty worklist state: (+inf distances, INVALID_ID, visited=True)."""
    return (
        torch.full((q, l), float("inf"), dtype=torch.float32, device=device),
        torch.full((q, l), INVALID_ID, dtype=torch.int32, device=device),
        torch.ones((q, l), dtype=torch.bool, device=device),
    )


def merge_worklist(
    wl_dist: torch.Tensor,
    wl_ids: torch.Tensor,
    wl_vis: torch.Tensor,
    cand_dist: torch.Tensor,
    cand_ids: torch.Tensor,
):
    """Merge candidates into the sorted worklist, keeping the best L.

    cand_dist must already be +inf for filtered-out lanes. Returns the new
    (wl_dist, wl_ids, wl_vis), each [Q, L]."""
    l = wl_dist.shape[1]
    keys = torch.cat([wl_dist, cand_dist], dim=1)
    ids = torch.cat([wl_ids, cand_ids], dim=1)
    vis = torch.cat([wl_vis, torch.zeros_like(cand_ids, dtype=torch.bool)], dim=1)
    sk, order = torch.sort(keys, dim=1, stable=True)
    order = order[:, :l]
    si = ids.gather(1, order)
    # Slots holding INVALID_ID must stay non-selectable.
    sv = vis.gather(1, order) | (si == INVALID_ID)
    return sk[:, :l], si, sv


def select_parents_beam(
    wl_dist: torch.Tensor, wl_ids: torch.Tensor, wl_vis: torch.Tensor, beam: int
):
    """Pick the first `beam` unvisited worklist entries per query and mark
    them visited (beam=1 is the reference's single-parent schedule).

    Returns (parents [Q, beam] i32 — 0-filled where invalid; valid [Q, beam]
    bool; active [Q] bool; updated wl_vis, a new tensor)."""
    q, l = wl_vis.shape
    pos = torch.arange(l, dtype=torch.int32, device=wl_vis.device).expand(q, l)
    sunk = -(l + 2)
    # keys: earlier unvisited slots first; visited slots sink below -(l+1)
    key = torch.where(~wl_vis, -pos, torch.full_like(pos, sunk))
    topk, topi = key.topk(beam, dim=1)
    valid = topk > sunk
    parents = torch.where(valid, wl_ids.gather(1, topi), torch.zeros_like(topk))
    # invalid lanes point at already-visited slots; rewriting their own
    # value there changes nothing (the JAX version drops them instead)
    wl_vis = wl_vis.scatter(1, topi, valid | wl_vis.gather(1, topi))
    active = valid[:, 0]
    return parents, valid, active, wl_vis
