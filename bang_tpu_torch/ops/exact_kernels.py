"""Kernel K3 of the exact-distance search, with its plain version.

Port of `exact_frontier_dma` (bang_tpu/ops/pq_pallas.py:564): the
traversal fetch of BANG_Exactdistance (parANN.cu:1139-1179). Given each
query's parents, K3 (`csrc/exact_frontier.cu`, CUDA C++ for sm_90a, built by
`ops/_build.py`) reads each parent's fused exact row (ops/l2.
pack_exact_frontier_rows) and returns the neighbors' ids and their exact
squared-L2 distances to the query, with no gathered copy of the rows.

The wrapper checks device, dtype, shape and contiguity and raises on what
the kernel does not take. For tensors on the CPU it returns the plain
version (`exact_frontier_plain`); for CUDA tensors it launches the kernel or
raises — there is no fallback. `exact_frontier.launches` counts launches,
which the kernel counts on the card (read and zeroed with the others by
`pq_kernels.launch_counts` and `reset_launch_counts`).

The Mosaic limits of the JAX kernel (R = 64, D % 128 == 0, DMA-tiled rows)
do not carry over: any R <= MAX_R, any beam <= 16, any D whose f32 query
and one parent row fit a block's shared memory (the kernel stages both with
`cp.async` and takes a wide beam's parents in groups), on flat rows.
"""

from __future__ import annotations

import torch

from bang_tpu_torch.constants import MAX_R
from bang_tpu_torch.ops._build import MAX_SHARED_BYTES, check_tensor, route
from bang_tpu_torch.ops.l2 import decode_exact_frontier_rows, l2_distance_to_candidates

MAX_BEAM = 16  # SearchParams.beam_width's bound


def _pad16(nbytes: int) -> int:
    """A block's shared memory holds the query and each parent row from a
    16-byte boundary."""
    return -(-nbytes // 16) * 16


def exact_frontier_plain(queries_f32, rows, parents):
    """Plain version of K3: row gather + decode_exact_frontier_rows +
    l2_distance_to_candidates (the counterpart of the JAX package's XLA
    path, bang_tpu/models/traversal.py:336-345).

    queries_f32 [Q, D] f32; rows [N, R*(8+D)] u8; parents [Q, beam] int32.
    Returns (ids [Q, beam*R] i32, dists [Q, beam*R] f32)."""
    d = queries_f32.shape[1]
    r = rows.shape[1] // (8 + d)
    ids, norms, vecs = decode_exact_frontier_rows(rows[parents.long()], r, d)
    return ids, l2_distance_to_candidates(queries_f32, vecs, norms)


def exact_frontier(queries_f32: torch.Tensor, rows: torch.Tensor,
                   parents: torch.Tensor):
    """K3: (ids, exact squared-L2 dists) of every neighbor of each query's
    parents, read from the ungathered fused exact rows.

    queries_f32: [Q, D] f32; rows: [N, R*(8+D)] u8
    (ops/l2.pack_exact_frontier_rows); parents: [Q, beam] int32 in [0, N);
    all contiguous, on one device. Returns (ids [Q, beam*R] i32,
    dists [Q, beam*R] f32), dists = max(||v||^2 - 2 q.v + ||q||^2, 0)."""
    check_tensor("queries_f32", queries_f32, torch.float32, 2)
    check_tensor("rows", rows, torch.uint8, 2)
    check_tensor("parents", parents, torch.int32, 2)
    q, d = queries_f32.shape
    n, row_w = rows.shape
    r, rem = divmod(row_w, 8 + d)
    if d < 1 or rem or not 1 <= r <= MAX_R:
        raise ValueError(
            f"rows width {row_w} is not R*(8+D) with D={d}, 1 <= R <= {MAX_R}"
        )
    beam = parents.shape[1]
    if parents.shape[0] != q or not 1 <= beam <= MAX_BEAM:
        raise ValueError(
            f"parents {tuple(parents.shape)} must be [Q={q}, beam<={MAX_BEAM}]"
        )
    query_bytes, row_bytes = _pad16(4 * d), _pad16(row_w)
    if query_bytes + row_bytes > MAX_SHARED_BYTES:
        raise ValueError(
            f"D={d}, R={r}: the kernel stages the f32 query ({query_bytes} B) "
            f"and at least one parent row ({row_bytes} B) in {MAX_SHARED_BYTES} "
            "bytes of shared memory"
        )
    if route(queries_f32, rows, parents) == "cpu":
        return exact_frontier_plain(queries_f32, rows, parents)
    from bang_tpu_torch.ops import _build

    ids = torch.empty((q, beam * r), dtype=torch.int32, device=rows.device)
    dists = torch.empty((q, beam * r), dtype=torch.float32, device=rows.device)
    if q == 0:
        return ids, dists
    lib = _build.load_library("exact_frontier")
    with torch.cuda.device(rows.device):
        err = lib.exact_frontier_launch(
            queries_f32.data_ptr(), rows.data_ptr(), parents.data_ptr(),
            ids.data_ptr(), dists.data_ptr(), n, q, r, d, beam,
            _build.launch_counter(exact_frontier, rows.device),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("exact_frontier", err)
    return ids, dists


exact_frontier.launches = 0
