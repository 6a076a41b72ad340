"""Exact visited-set filtering (port of bang_tpu/ops/visited.py).

A candidate is new iff it appears in neither the current worklist nor the
list of already-expanded parents: an exact membership test with no false
positives. The reference (BANG) keeps a per-query bloom filter instead,
ported as ops/bloom.py (`visited_mode="bloom"`).

Re-entry semantics are kept on purpose: a node that entered the worklist
but was evicted before it was expanded may re-enter later (it is in neither
list). The bloom filter blocks that; the JAX package's two modes differ the
same way, which keeps iteration counts comparable with it in each mode.
"""

from __future__ import annotations

import torch


def exact_new_mask(
    cand_ids: torch.Tensor, wl_ids: torch.Tensor, visited_ids: torch.Tensor
) -> torch.Tensor:
    """new[q, r] = cand not in worklist and not among expanded parents.

    cand_ids: [Q, C] i32; wl_ids: [Q, L] i32; visited_ids: [Q, MI] i32
    (INVALID_ID padding never matches valid candidates; an INVALID_ID
    candidate matches it, as in the dense form).

    The same function as `exact_new_mask_dense`, computed by sorting: one
    row sort of the worklist and visited ids together ([Q, L + MI]), a
    binary search of each candidate in its row, and one compare of the id
    found there. The JAX package writes the dense compare and leaves it to
    XLA to fuse the compare and the `any` into one reduction; eager PyTorch
    fuses nothing, so the dense form writes and re-reads [Q, C, L] and
    [Q, C, MI] bool tensors every iteration."""
    known = torch.sort(torch.cat([wl_ids, visited_ids], dim=1), dim=1).values
    idx = torch.searchsorted(known, cand_ids)
    idx.clamp_(max=known.shape[1] - 1)  # past the row's last id: not found
    return known.gather(1, idx) != cand_ids


def exact_new_mask_dense(
    cand_ids: torch.Tensor, wl_ids: torch.Tensor, visited_ids: torch.Tensor
) -> torch.Tensor:
    """The dense form of `exact_new_mask`, the JAX package's expression: the
    plain oracle that the tests and chip_smoke.py hold the sorted form to."""
    in_wl = (cand_ids[:, :, None] == wl_ids[:, None, :]).any(-1)
    in_vis = (cand_ids[:, :, None] == visited_ids[:, None, :]).any(-1)
    return ~(in_wl | in_vis)


def first_occurrence_mask(cand_ids: torch.Tensor) -> torch.Tensor:
    """True where cand_ids[q, j] is the first occurrence in its row: the
    generic O(C^2) form, the oracle of first_occurrence_mask_blocks (the
    search path's form), as in the JAX package."""
    c = cand_ids.shape[1]
    eq = cand_ids[:, :, None] == cand_ids[:, None, :]  # [Q, C, C]
    earlier = torch.ones((c, c), dtype=torch.bool, device=cand_ids.device).tril(-1)
    return ~(eq & earlier[None]).any(-1)


def first_occurrence_mask_blocks(cand_ids: torch.Tensor, beam: int) -> torch.Tensor:
    """True where cand_ids[q, j] is the first occurrence in its row, for
    candidates that come as `beam` per-parent blocks of width R.

    Adjacency rows are duplicate-free, so duplicates only occur across
    blocks: each block is compared against the earlier blocks only."""
    q, c = cand_ids.shape
    r = c // beam
    blocks = cand_ids.reshape(q, beam, r)
    mask = torch.ones((q, beam, r), dtype=torch.bool, device=cand_ids.device)
    for b in range(1, beam):
        dup = (
            blocks[:, b, :, None] == blocks[:, :b].reshape(q, 1, b * r)
        ).any(-1)
        mask[:, b] = ~dup
    return mask.reshape(q, c)
