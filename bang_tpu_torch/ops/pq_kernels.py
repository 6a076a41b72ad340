"""The two Hopper kernels of the in-memory search, with their plain versions.

Port of bang_tpu/ops/pq_pallas.py. Kernels (CUDA C++ for sm_90a under
`csrc/`, built by `ops/_build.py`):

  K1 `pq_lookup`        replaces `pq_lookup_packed` — PQ lookup over codes
                        gathered per candidate (scattered-codes layout),
                        over f32 tables.
  K2 `frontier_lookup`  replaces `frontier_lookup` and `frontier_lookup_dma`
                        — candidate ids and PQ distances read straight from
                        the ungathered fused rows of each query's parents
                        (fused-row layout, the default), over the JAX
                        kernels' bf16-pair tables.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. For tensors on the CPU it returns its plain
version (`pq_lookup_plain`, `frontier_lookup_plain`); for CUDA tensors it
launches the kernel or raises — there is no fallback. `<wrapper>.launches`
counts kernel launches, so a run can show that its main path went through
the kernels; `reset_launch_counts` zeroes all of them: K3 `exact_frontier`
(ops/exact_kernels.py) and K4-K6 (ops/probe_kernels.py) included.

Table forms: K2 reads the bf16-pair tables the JAX package's fused route
reads on its accelerator (`pack_tables`; ops/pq.py, bit-identical to
JAX's), so its sums are the bf16 entries' and equal K6 + K5's bit for bit.
K1 still streams f32 tables; its packed form, K4, is measured but not on a
search path. `frontier_decode_plain` is the fused route's f32 decode, JAX's
`frontier_decode_xla`: the route the CPU takes, as under JAX's
`impl="auto"`.
"""

from __future__ import annotations

import torch

from bang_tpu_torch.constants import INVALID_ID, MAX_R
from bang_tpu_torch.ops._build import (
    MAX_SHARED_BYTES,
    check_aligned,
    check_packed,
    check_tensor,
    route,
)
from bang_tpu_torch.ops.adjacency import decode_adj_planes, pack_adj_planes
from bang_tpu_torch.ops.exact_kernels import exact_frontier
from bang_tpu_torch.ops.pq import pack_tables, unpack_tables  # noqa: F401
from bang_tpu_torch.ops.pq import pq_lookup as pq_lookup_plain
from bang_tpu_torch.ops.probe_kernels import (
    frontier_packed,
    frontier_packed_plain,
    lookup_packed,
    row_gather,
)

# K1 stages one query's m x 256 f32 table in shared memory (MAX_SHARED_BYTES
# at most).
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


def frontier_lookup_plain(packed, fused_rows, parents):
    """Plain version of K2: the row gather, then the decode and bf16-pair
    lookup of K5's plain version (probe_kernels.frontier_packed_plain). A
    parent outside [0, N) gives id -1 and +inf on its R lanes, as the
    kernel does.

    packed [Q, m, 128] int32; fused_rows [N, R*(4+m)] u8; parents [Q, beam]
    int32. Returns (ids [Q, beam*R] i32, dists [Q, beam*R] f32)."""
    m = packed.shape[1]
    n = fused_rows.shape[0]
    r = fused_rows.shape[1] // (4 + m)
    p = parents.long()
    rows = fused_rows[p.clamp(0, n - 1)]  # [Q, beam, 4R + m*R]
    ids, dists = frontier_packed_plain(packed, rows, r, 4)
    bad = ((p < 0) | (p >= n)).repeat_interleave(r, dim=1)
    return (ids.masked_fill(bad, INVALID_ID),
            dists.masked_fill(bad, float("inf")))


def frontier_decode_plain(tables, fused_rows, parents):
    """The fused-row decode over f32 tables (the counterpart of the JAX
    `frontier_decode_xla`): row gather + byte-plane decode +
    pq_lookup_plain. The fused route on the CPU; no kernel sits behind it.

    tables [Q, m, 256] f32; fused_rows [N, R*(4+m)] u8; parents [Q, beam]
    int32 in [0, N). Returns (ids [Q, beam*R] i32, dists [Q, beam*R] f32)."""
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


def frontier_lookup(packed: torch.Tensor, fused_rows: torch.Tensor,
                    parents: torch.Tensor):
    """K2: (ids, dists) of every neighbor of each query's parents, read from
    the ungathered fused rows, over bf16-pair tables.

    packed: [Q, m, 128] int32 (pack_tables), on a 16-byte boundary;
    fused_rows: [N, R*(4+m)] u8 (pack_frontier_rows); parents: [Q, beam]
    int32; all contiguous, on one device. dists[q, b*R + j] is the f32 sum
    of the m bf16 entries of neighbor j of parent b, added in chunk order;
    a parent outside [0, N) gives id -1 and +inf. Returns (ids [Q, beam*R]
    i32, dists [Q, beam*R] f32)."""
    q, m = check_packed(packed)
    check_aligned(packed)
    check_tensor("fused_rows", fused_rows, torch.uint8, 2)
    check_tensor("parents", parents, torch.int32, 2)
    n, row_w = fused_rows.shape
    r, rem = divmod(row_w, 4 + m)
    if rem or not 1 <= r <= MAX_R:
        raise ValueError(
            f"fused_rows width {row_w} is not R*(4+m) with m={m}, "
            f"1 <= R <= {MAX_R}"
        )
    if m * 512 + -(-row_w // 16) * 16 > MAX_SHARED_BYTES:
        raise ValueError(
            f"m={m}, R={r}: the kernel stages the m x 128 int32 table and one "
            f"{row_w}-byte row in shared memory, {MAX_SHARED_BYTES} bytes at most"
        )
    beam = parents.shape[1]
    if parents.shape[0] != q or not 1 <= beam <= MAX_BEAM:
        raise ValueError(
            f"parents {tuple(parents.shape)} must be [Q={q}, beam<={MAX_BEAM}]"
        )
    if route(packed, fused_rows, parents) == "cpu":
        return frontier_lookup_plain(packed, fused_rows, parents)
    from bang_tpu_torch.ops import _build

    ids = torch.empty((q, beam * r), dtype=torch.int32, device=packed.device)
    dists = torch.empty((q, beam * r), dtype=torch.float32, device=packed.device)
    if q == 0:
        return ids, dists
    lib = _build.load_library("frontier_lookup")
    with torch.cuda.device(packed.device):
        err = lib.frontier_lookup_launch(
            packed.data_ptr(), fused_rows.data_ptr(), parents.data_ptr(),
            ids.data_ptr(), dists.data_ptr(), n, q, r, m, beam,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("frontier_lookup", err)
    frontier_lookup.launches += 1
    return ids, dists


frontier_lookup.launches = 0

# every kernel wrapper of the port: K1-K2 here, K3 (ops/exact_kernels),
# K4-K6 (ops/probe_kernels)
KERNELS = (pq_lookup, frontier_lookup, exact_frontier, lookup_packed,
           frontier_packed, row_gather)


def reset_launch_counts() -> None:
    """Zero the launch counts of every kernel in KERNELS."""
    for k in KERNELS:
        k.launches = 0
