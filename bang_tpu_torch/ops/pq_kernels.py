"""The two Hopper kernels of the in-memory search, with their plain versions.

Port of bang_tpu/ops/pq_pallas.py. Kernels (CUDA C++ for sm_90a under
`csrc/`, built by `ops/_build.py`):

  K1 `pq_lookup`        replaces `pq_lookup_packed` — PQ lookup over codes
                        gathered per candidate (scattered-codes layout).
  K2 `frontier_lookup`  replaces `frontier_lookup` and `frontier_lookup_dma`
                        — candidate ids and PQ distances read straight from
                        the ungathered fused rows of each query's parents
                        (fused-row layout, the default).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. For tensors on the CPU it returns its plain
version (`pq_lookup_plain`, `frontier_lookup_plain`); for CUDA tensors it
launches the kernel or raises — there is no fallback. `<wrapper>.launches`
counts kernel launches, so a run can show that its main path went through
the kernels; `reset_launch_counts` zeroes all of them, K3 `exact_frontier`
(ops/exact_kernels.py) included.

Tables stay f32: the JAX kernels' bf16-pair packing (`pack_tables`) fits a
TPU lane register and is not ported.
"""

from __future__ import annotations

import torch

from bang_tpu.constants import MAX_R
from bang_tpu_torch.ops._build import check_tensor, route
from bang_tpu_torch.ops.adjacency import decode_adj_planes, pack_adj_planes
from bang_tpu_torch.ops.exact_kernels import exact_frontier
from bang_tpu_torch.ops.pq import pq_lookup as pq_lookup_plain

# A block stages one query's m x 256 f32 table in shared memory; an H100
# block can use at most 227 KB (232,448 bytes) of it.
MAX_SHARED_BYTES = 232_448
MAX_CHUNKS = MAX_SHARED_BYTES // (256 * 4)  # 227
MAX_BEAM = 16  # SearchParams.beam_width's bound


def pack_frontier_rows(adj: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Fused frontier rows [B, 4R + m*R] u8 for the adjacency rows `adj`.

    Per node, byte-contiguous:
      [ id byte-plane 0 (R bytes) | plane 1 | plane 2 | plane 3 |
        chunk-major codes: chunk 0's R codes | ... | chunk m-1's R codes ]

    adj: [B, R] int32 (self-padded); codes: [N, m] u8, on the same device.
    Byte-identical to the JAX package's rows; any R (the JAX gate of R % 64
    or R == 32 is a Mosaic limit)."""
    b, r = adj.shape
    m = codes.shape[1]
    planes = pack_adj_planes(adj)
    nbr = codes[adj.long()]  # [B, R, m]
    cm = nbr.transpose(1, 2).reshape(b, m * r)
    return torch.cat([planes, cm], dim=1)


def frontier_lookup_plain(tables, fused_rows, parents):
    """Plain version of K2: row gather + byte-plane decode + pq_lookup_plain
    (the counterpart of the JAX `frontier_decode_xla`).

    tables [Q, m, 256] f32; fused_rows [N, R*(4+m)] u8; parents [Q, beam]
    int32. Returns (ids [Q, beam*R] i32, dists [Q, beam*R] f32)."""
    q, m, _ = tables.shape
    beam = parents.shape[1]
    r = fused_rows.shape[1] // (4 + m)
    rows = fused_rows[parents.long()]  # [Q, beam, 4R + m*R]
    ids = decode_adj_planes(rows[..., : 4 * r]).reshape(q, beam * r)
    cd = rows[..., 4 * r :].reshape(q, beam, m, r)
    codes = cd.transpose(2, 3).reshape(q, beam * r, m)  # [Q, C, m]
    return ids, pq_lookup_plain(tables, codes)


def _check_tables(tables):
    check_tensor("tables", tables, torch.float32, 3)
    q, m, nc = tables.shape
    if nc != 256:
        raise ValueError(f"tables must be [Q, m, 256], got {tuple(tables.shape)}")
    if not 1 <= m <= MAX_CHUNKS:
        raise ValueError(
            f"m={m} chunks: the kernel stages an m x 256 f32 table in shared "
            f"memory and takes 1 <= m <= {MAX_CHUNKS}"
        )
    return q, m


def pq_lookup(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """K1: out[q, j] = sum_c tables[q, c, codes[q, j, c]].

    tables: [Q, m, 256] f32; codes: [Q, C, m] u8 (gathered per candidate);
    both contiguous, on one device. Returns [Q, C] f32."""
    q, m = _check_tables(tables)
    check_tensor("codes", codes, torch.uint8, 3)
    if codes.shape[0] != q or codes.shape[2] != m:
        raise ValueError(
            f"codes {tuple(codes.shape)} do not match tables {tuple(tables.shape)}"
        )
    if route(tables, codes) == "cpu":
        return pq_lookup_plain(tables, codes)
    from bang_tpu_torch.ops import _build

    c = codes.shape[1]
    out = torch.empty((q, c), dtype=torch.float32, device=tables.device)
    if q == 0 or c == 0:
        return out
    lib = _build.load_library("pq_lookup")
    with torch.cuda.device(tables.device):
        err = lib.pq_lookup_launch(
            tables.data_ptr(), codes.data_ptr(), out.data_ptr(), q, c, m,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("pq_lookup", err)
    pq_lookup.launches += 1
    return out


pq_lookup.launches = 0


def frontier_lookup(tables: torch.Tensor, fused_rows: torch.Tensor,
                    parents: torch.Tensor):
    """K2: (ids, dists) of every neighbor of each query's parents, read from
    the ungathered fused rows.

    tables: [Q, m, 256] f32; fused_rows: [N, R*(4+m)] u8
    (pack_frontier_rows); parents: [Q, beam] int32 in [0, N); all
    contiguous, on one device. Returns (ids [Q, beam*R] i32, dists
    [Q, beam*R] f32)."""
    q, m = _check_tables(tables)
    check_tensor("fused_rows", fused_rows, torch.uint8, 2)
    check_tensor("parents", parents, torch.int32, 2)
    n, row_w = fused_rows.shape
    r, rem = divmod(row_w, 4 + m)
    if rem or not 1 <= r <= MAX_R:
        raise ValueError(
            f"fused_rows width {row_w} is not R*(4+m) with m={m}, "
            f"1 <= R <= {MAX_R}"
        )
    beam = parents.shape[1]
    if parents.shape[0] != q or not 1 <= beam <= MAX_BEAM:
        raise ValueError(
            f"parents {tuple(parents.shape)} must be [Q={q}, beam<={MAX_BEAM}]"
        )
    if route(tables, fused_rows, parents) == "cpu":
        return frontier_lookup_plain(tables, fused_rows, parents)
    from bang_tpu_torch.ops import _build

    ids = torch.empty((q, beam * r), dtype=torch.int32, device=tables.device)
    dists = torch.empty((q, beam * r), dtype=torch.float32, device=tables.device)
    if q == 0:
        return ids, dists
    lib = _build.load_library("frontier_lookup")
    with torch.cuda.device(tables.device):
        err = lib.frontier_lookup_launch(
            tables.data_ptr(), fused_rows.data_ptr(), parents.data_ptr(),
            ids.data_ptr(), dists.data_ptr(), n, q, r, m, beam,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("frontier_lookup", err)
    frontier_lookup.launches += 1
    return ids, dists


frontier_lookup.launches = 0

# every kernel wrapper of the port, K3 (ops/exact_kernels) included
KERNELS = (pq_lookup, frontier_lookup, exact_frontier)


def reset_launch_counts() -> None:
    """Zero the launch counts of every kernel in KERNELS."""
    for k in KERNELS:
        k.launches = 0
