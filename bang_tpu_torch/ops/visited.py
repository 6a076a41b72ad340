"""Exact visited-set filtering (port of bang_tpu/ops/visited.py).

A candidate is new iff it appears in neither the current worklist nor the
list of already-expanded parents: an exact membership test with no false
positives. The reference (BANG) keeps a per-query bloom filter instead,
ported as ops/bloom.py (`visited_mode="bloom"`).

Re-entry semantics are kept on purpose: a node that entered the worklist
but was evicted before it was expanded may re-enter later (it is in neither
list). The bloom filter blocks that; the JAX package's two modes differ the
same way, which keeps iteration counts comparable with it in each mode.

The traversal step's whole exact-mode filter is `visited_filter`: the
membership test, the parents' validity, the query's activity, the beam's
first-occurrence mask and the +inf masking of filtered lanes. On CUDA
tensors it is one launch of `csrc/visited_filter.cu` (built by
ops/_build.py), which replaces no TPU kernel: the JAX package leaves the
filter to XLA, which fuses it, where eager PyTorch runs about a dozen
kernels a step. On CPU tensors it is its plain version,
`visited_filter_plain`, the composition of the functions below; for CUDA
tensors it launches the kernel or raises, with no fallback.
`visited_filter.launches` counts launches, which the kernel counts on the
card (read and zeroed with the others by ops/pq_kernels.launch_counts and
reset_launch_counts).
"""

from __future__ import annotations

import torch

from bang_tpu_torch.ops._build import MAX_SHARED_BYTES, check_tensor, route

MAX_BEAM = 16  # SearchParams.beam_width's bound


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


def table_slots(n: int) -> int:
    """The slots of the kernel's hash table for n ids: the least power of
    two, at least 32, not below 4n/3 (a load of at most 3/4)."""
    slots = 32
    while 3 * slots < 4 * n:
        slots *= 2
    return slots


def visited_filter_plain(cand, raw, wl_ids, visited_ids, parent_valid, active, beam):
    """Plain version of the visited filter kernel: the exact mask, the
    parents' validity over their blocks, the query's activity, the beam's
    first-occurrence mask (beam > 1) and +inf on every filtered lane.

    cand [Q, C=beam*R] i32; raw [Q, C] f32; wl_ids [Q, L] i32; visited_ids
    [Q, V] i32; parent_valid [Q, beam] bool; active [Q] bool. Returns
    (new [Q, C] bool, dist [Q, C] f32)."""
    q, c = cand.shape
    r = c // beam
    cand_valid = parent_valid[:, :, None].expand(q, beam, r).reshape(q, c)
    new = exact_new_mask(cand, wl_ids, visited_ids) & cand_valid & active[:, None]
    if beam > 1:
        # parents expanded together may share neighbors — keep first lane
        new = new & first_occurrence_mask_blocks(cand, beam)
    return new, torch.where(new, raw, torch.full_like(raw, float("inf")))


def visited_filter(cand: torch.Tensor, raw: torch.Tensor, wl_ids: torch.Tensor,
                   visited_ids: torch.Tensor, parent_valid: torch.Tensor,
                   active: torch.Tensor, beam: int):
    """The exact-mode visited filter of one traversal step, in one launch on
    the card: (new, dist), bit for bit `visited_filter_plain`'s.

    cand: [Q, C] int32, C = beam*R; raw: [Q, C] f32; wl_ids: [Q, L] int32
    (L >= 1); visited_ids: [Q, V] int32; parent_valid: [Q, beam] bool;
    active: [Q] bool; all contiguous, on one device; 1 <= beam <= 16. The
    kernel keeps a query's ids in a hash table in shared memory, 12 bytes a
    slot over `table_slots(L + V + C)` slots, at most MAX_SHARED_BYTES.
    Returns (new [Q, C] bool, dist [Q, C] f32)."""
    check_tensor("cand", cand, torch.int32, 2)
    check_tensor("raw", raw, torch.float32, 2)
    check_tensor("wl_ids", wl_ids, torch.int32, 2)
    check_tensor("visited_ids", visited_ids, torch.int32, 2)
    check_tensor("parent_valid", parent_valid, torch.bool, 2)
    check_tensor("active", active, torch.bool, 1)
    q, c = cand.shape
    l, v = wl_ids.shape[1], visited_ids.shape[1]
    if not 1 <= beam <= MAX_BEAM or c % beam:
        raise ValueError(f"beam={beam}: 1 <= beam <= {MAX_BEAM}, dividing C={c}")
    if (raw.shape != (q, c) or wl_ids.shape[0] != q or visited_ids.shape[0] != q
            or parent_valid.shape != (q, beam) or active.shape != (q,) or l < 1):
        raise ValueError(
            f"shapes cand {tuple(cand.shape)}, raw {tuple(raw.shape)}, wl_ids "
            f"{tuple(wl_ids.shape)}, visited_ids {tuple(visited_ids.shape)}, "
            f"parent_valid {tuple(parent_valid.shape)}, active {tuple(active.shape)}: "
            f"need [Q, C], [Q, C], [Q, L>=1], [Q, V], [Q, beam={beam}], [Q]"
        )
    smem = 12 * table_slots(l + v + c)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"L={l}, V={v}, C={c}: the kernel's hash table of a query's ids "
            f"({smem} bytes) must fit {MAX_SHARED_BYTES} bytes of shared memory"
        )
    if route(cand, raw, wl_ids, visited_ids, parent_valid, active) == "cpu":
        return visited_filter_plain(cand, raw, wl_ids, visited_ids, parent_valid,
                                    active, beam)
    from bang_tpu_torch.ops import _build

    new = torch.empty((q, c), dtype=torch.bool, device=cand.device)
    dist = torch.empty((q, c), dtype=torch.float32, device=cand.device)
    if q == 0 or c == 0:
        return new, dist
    lib = _build.load_library("visited_filter")
    with torch.cuda.device(cand.device):
        err = lib.visited_filter_launch(
            cand.data_ptr(), raw.data_ptr(), wl_ids.data_ptr(), visited_ids.data_ptr(),
            parent_valid.data_ptr(), active.data_ptr(), new.data_ptr(), dist.data_ptr(),
            q, c, l, v, beam,
            _build.launch_counter(visited_filter, cand.device),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("visited_filter", err)
    return new, dist


visited_filter.launches = 0
