"""Worklist (best-L set) maintenance: sorted merge and parent selection.

Port of bang_tpu/ops/merge.py (`init_worklist`, `merge_worklist`,
`select_parents_beam`), the re-design of the reference's
`compute_BestLSets_par_sort_msort` + `compute_BestLSets_par_merge` +
`compute_parent1/2` (BANG_Base/bang_search.cu:1384-1715).

`merge_worklist` is one stable `torch.sort` of concat(worklist, candidates)
by distance — the same concat order as the JAX `lax.sort`, so distance ties
keep worklist entries first and results are bit-identical. Its merge-path
form `merge_worklist_ranked` (bit-identical output) sorts only the C
candidates and places both sides by compare-and-sum ranks, since the
worklist is sorted already. `BANG_MERGE_IMPL=ranked` selects it, as in the
JAX package; the port reads the variable at each call (`merge_impl`), so a
process can switch, and a captured loop's key names the form it captured
(models/compiled.GraphCache). Both are plain PyTorch: JAX computes them in
XLA, outside any Pallas kernel.

Empty slots carry id INVALID_ID, distance +inf, visited=True, so they sort
to the tail and are never selected.
"""

from __future__ import annotations

import os

import torch

from bang_tpu_torch.constants import INVALID_ID


def merge_impl() -> str:
    """The merge form `BANG_MERGE_IMPL` names now: "ranked", or "sort" for
    any other value or none (the JAX package's reading)."""
    return "ranked" if os.environ.get("BANG_MERGE_IMPL") == "ranked" else "sort"


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
    impl: str | None = None,
):
    """Merge candidates into the sorted worklist, keeping the best L.

    cand_dist must already be +inf for filtered-out lanes. Returns the new
    (wl_dist, wl_ids, wl_vis), each [Q, L]. impl: "sort" or "ranked"; None
    reads BANG_MERGE_IMPL (`merge_impl`). The worklist side is always
    sorted (init_worklist's all-inf state; every merge's output), which the
    ranked form relies on."""
    if (impl or merge_impl()) == "ranked":
        return merge_worklist_ranked(wl_dist, wl_ids, wl_vis, cand_dist, cand_ids)
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


def merge_worklist_ranked(
    wl_dist: torch.Tensor,
    wl_ids: torch.Tensor,
    wl_vis: torch.Tensor,
    cand_dist: torch.Tensor,
    cand_ids: torch.Tensor,
):
    """Merge-path form of merge_worklist (bit-identical output): a stable
    sort of the C candidates only, then each side's place in the merged
    order by compare and sum,

      rank_wl[i] = i + #{j: cd[j] <  wl[i]}   (ties go to the worklist, as
      rank_c[j]  = j + #{i: wl[i] <= cd[j]}    the stable concat sort keeps them)

    and output slot k takes wl[k - f(k)], f(k) = #{j: rank_c[j] < k} the
    candidates placed before it, unless that worklist entry's rank is not
    k, when it takes the candidate at sorted position f(k). The compares
    are [Q, L, C] bool tensors (0.66 GB each at Q=10K, L=512, C=128)."""
    q, l = wl_dist.shape
    c = cand_dist.shape[1]
    dev = wl_dist.device
    i32 = torch.int32
    iota_l = torch.arange(l, dtype=i32, device=dev)[None]
    cd, order = torch.sort(cand_dist, dim=1, stable=True)
    ci = cand_ids.gather(1, order)
    rank_wl = iota_l + (cd[:, None, :] < wl_dist[:, :, None]).sum(-1, dtype=i32)
    rank_c = (torch.arange(c, dtype=i32, device=dev)[None]
              + (wl_dist[:, :, None] <= cd[:, None, :]).sum(1, dtype=i32))  # [Q, C]
    # f[k]: candidates placed before slot k; g[k] = k - f[k], the worklist
    # entry that fills slot k when no candidate does (ranks are distinct)
    f = (rank_c[:, None, :] < iota_l[:, :, None]).sum(-1, dtype=i32)
    g = (iota_l - f).long()  # gather's index type
    f_s = f.clamp(max=c - 1).long()  # f == C only where the worklist fills it
    from_wl = rank_wl.gather(1, g) == iota_l
    out_d = torch.where(from_wl, wl_dist.gather(1, g), cd.gather(1, f_s))
    out_i = torch.where(from_wl, wl_ids.gather(1, g), ci.gather(1, f_s))
    out_v = (from_wl & wl_vis.gather(1, g)) | (out_i == INVALID_ID)
    return out_d, out_i, out_v


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
