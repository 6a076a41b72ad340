"""The counterparts of the Pallas layout probes in the JAX package's
`scripts/`, with their plain versions: `lookup_packed` (K1's kernel) and
kernels K5-K6.

The six probes computed PQ lookups over bf16-pair tables (`pack_tables`,
ops/pq.py) in the code layouts K1 and K2 took or rejected on the TPU, and a
bare dynamic row copy. On the card the layouts that differed only in how
Mosaic moved bytes into vector registers are one function, so three CUDA
kernels (sm_90a, under `csrc/`, built by `ops/_build.py`) serve all six:

  `lookup_packed`       replaces `lookup_v2` (scripts/exp_lookup.py:85),
                        `lookup_flat` (scripts/exp_flat_lookup.py:90) and
                        `v6` (scripts/exp_flat2.py:106): out[q, j] =
                        sum_c bf16(T)[q, c, codes[q, j, c]] over codes
                        [Q, C, m] (a flat [Q, C*m] buffer is the same bytes).
                        The in-memory search's scattered route computes the
                        same function, so this wrapper launches K1
                        (csrc/pq_lookup.cu) through `run_lookup`, which
                        ops/pq_kernels.pq_lookup shares, and counts its own
                        launches.
  K5 `frontier_packed`  replaces `fused_lookup` (scripts/exp_fused.py:79,
                        id_planes=4) and `v7` (scripts/exp_flat2.py:148,
                        id_planes=0): ids and PQ distances from gathered
                        rows [Q, beam, id_planes*R + m*R] with chunk-major
                        codes.
  K6 `row_gather`       replaces `sublane_probe`
                        (scripts/exp_dma_tiled.py:71): out[i] =
                        rows[parents[i]] for flat u8 rows of any width.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. For tensors on the CPU it returns its plain
version; for CUDA tensors it launches the kernel or raises — there is no
fallback. `<wrapper>.launches` counts launches, which each kernel counts on
the card (read and zeroed with the others by `pq_kernels.launch_counts` and
`reset_launch_counts`). The search path calls none of these
wrappers; `bang_tpu_torch/scripts/` drives them at the probes' own sizes.
"""

from __future__ import annotations

import torch

from bang_tpu_torch.constants import MAX_R
from bang_tpu_torch.ops._build import (
    MAX_LOOKUP_CHUNKS,
    check_aligned,
    check_packed,
    check_tensor,
    route,
)
from bang_tpu_torch.ops.adjacency import decode_adj_planes
from bang_tpu_torch.ops.pq import pq_lookup, unpack_tables

MAX_BEAM = 16  # SearchParams.beam_width's bound
ID_PLANES = (0, 4)


def lookup_packed_plain(packed, codes):
    """Plain version of K1 (and so of `lookup_packed`): unpack to f32, then
    the gather-sum of ops/pq.pq_lookup. packed [Q, m, 128] int32; codes
    [Q, C, m] u8."""
    return pq_lookup(unpack_tables(packed), codes)


def check_lookup(packed, codes) -> None:
    """Raise unless (packed, codes) is what K1 takes."""
    q, m = check_packed(packed)
    check_aligned(packed)
    check_tensor("codes", codes, torch.uint8, 3)
    if codes.shape[0] != q or codes.shape[2] != m:
        raise ValueError(
            f"codes {tuple(codes.shape)} do not match packed {tuple(packed.shape)}"
        )
    if m > MAX_LOOKUP_CHUNKS:
        raise ValueError(
            f"m={m}: the kernel stages the m x 128 int32 table and at least one "
            f"code row in shared memory, so it takes m <= {MAX_LOOKUP_CHUNKS}"
        )


def run_lookup(wrapper, packed, codes) -> torch.Tensor:
    """K1 on (packed, codes) for `wrapper`, one of the two wrappers that
    compute its function (ops/pq_kernels.pq_lookup, `lookup_packed`): the
    checks, the plain version for CPU tensors, else the kernel, which
    counts its launch in `wrapper`'s slot of the card's counter. Here, below both wrappers, because
    ops/pq_kernels imports this module."""
    check_lookup(packed, codes)
    if route(packed, codes) == "cpu":
        return lookup_packed_plain(packed, codes)
    from bang_tpu_torch.ops import _build

    q, c, m = codes.shape
    out = torch.empty((q, c), dtype=torch.float32, device=packed.device)
    if q == 0 or c == 0:
        return out
    lib = _build.load_library("pq_lookup")
    with torch.cuda.device(packed.device):
        err = lib.pq_lookup_launch(
            packed.data_ptr(), codes.data_ptr(), out.data_ptr(), q, c, m,
            _build.launch_counter(wrapper, packed.device),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("pq_lookup", err)
    return out


def lookup_packed(packed: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """out[q, j] = sum_c bf16(T)[q, c, codes[q, j, c]], summed in f32 in
    chunk order: K1 (ops/pq_kernels.pq_lookup) under the probes' name, with
    K1's checks and its own launch count.

    packed: [Q, m, 128] int32 (pack_tables); codes: [Q, C, m] u8; both
    contiguous, on one device. Returns [Q, C] f32."""
    return run_lookup(lookup_packed, packed, codes)


lookup_packed.launches = 0


def frontier_packed_plain(packed, rows, r, id_planes):
    """Plain version of K5: byte-plane decode + lookup_packed_plain over the
    chunk-major codes. Returns (ids [Q, beam*R] i32 or None, dists)."""
    q, m, _ = packed.shape
    beam = rows.shape[1]
    ids = None
    if id_planes:
        ids = decode_adj_planes(rows[..., : 4 * r]).reshape(q, beam * r)
    cd = rows[..., id_planes * r :].reshape(q, beam, m, r)
    codes = cd.transpose(2, 3).reshape(q, beam * r, m)  # [Q, C, m]
    return ids, lookup_packed_plain(packed, codes)


def frontier_packed(packed: torch.Tensor, rows: torch.Tensor, r: int,
                    id_planes: int):
    """K5: (ids, dists) of every neighbor in each query's gathered rows.

    packed: [Q, m, 128] int32; rows: [Q, beam, id_planes*R + m*R] u8, per
    parent `id_planes` little-endian id byte-planes of R bytes (4, as in
    the fused frontier rows, or 0), then m chunk-major groups of R codes;
    all contiguous, on one device. Returns (ids [Q, beam*R] int32, or None
    when id_planes == 0, dists [Q, beam*R] f32)."""
    q, m = check_packed(packed)
    check_tensor("rows", rows, torch.uint8, 3)
    if id_planes not in ID_PLANES:
        raise ValueError(f"id_planes must be one of {ID_PLANES}, got {id_planes}")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"R={r}: the kernel takes 1 <= R <= {MAX_R}")
    beam, row_w = rows.shape[1:]
    if rows.shape[0] != q or not 1 <= beam <= MAX_BEAM:
        raise ValueError(
            f"rows {tuple(rows.shape)} must be [Q={q}, beam<={MAX_BEAM}, ...]"
        )
    if row_w != (id_planes + m) * r:
        raise ValueError(
            f"rows width {row_w} is not (id_planes + m) * R = "
            f"({id_planes} + {m}) * {r}"
        )
    if route(packed, rows) == "cpu":
        return frontier_packed_plain(packed, rows, r, id_planes)
    check_aligned(packed)
    from bang_tpu_torch.ops import _build

    c = beam * r
    ids = (torch.empty((q, c), dtype=torch.int32, device=rows.device)
           if id_planes else None)
    dists = torch.empty((q, c), dtype=torch.float32, device=rows.device)
    if q == 0:
        return ids, dists
    lib = _build.load_library("frontier_packed")
    with torch.cuda.device(rows.device):
        err = lib.frontier_packed_launch(
            packed.data_ptr(), rows.data_ptr(),
            ids.data_ptr() if id_planes else None, dists.data_ptr(),
            q, r, m, beam, id_planes,
            _build.launch_counter(frontier_packed, rows.device),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("frontier_packed", err)
    return ids, dists


frontier_packed.launches = 0


def row_gather_plain(rows, parents):
    """Plain version of K6: rows[parents]."""
    return rows[parents.long()]


def row_gather(rows: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """K6: out[i, :] = rows[parents[i], :].

    rows: [N, S] u8, any width S; parents: [P] int32; both contiguous, on
    one device. Returns [P, S] u8. On the CPU a parent outside [0, N)
    raises; on the card the kernel writes a zero row for it (the wrapper
    does not read the parents back to check)."""
    check_tensor("rows", rows, torch.uint8, 2)
    check_tensor("parents", parents, torch.int32, 1)
    n, s = rows.shape
    if route(rows, parents) == "cpu":
        bad = (parents < 0) | (parents >= n)
        if bool(bad.any()):
            raise ValueError(
                f"parents {parents[bad][:4].tolist()} lie outside [0, {n})"
            )
        return row_gather_plain(rows, parents)
    from bang_tpu_torch.ops import _build

    p = parents.shape[0]
    out = torch.empty((p, s), dtype=torch.uint8, device=rows.device)
    if p == 0 or s == 0:
        return out
    lib = _build.load_library("row_gather")
    with torch.cuda.device(rows.device):
        err = lib.row_gather_launch(
            rows.data_ptr(), parents.data_ptr(), out.data_ptr(), n, p, s,
            _build.launch_counter(row_gather, rows.device),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("row_gather", err)
    return out


row_gather.launches = 0
