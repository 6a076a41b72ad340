"""Byte-plane neighbor ids (port of the id math of bang_tpu/ops/adjacency.py).

An [N, R] int32 neighbor table as [N, 4R] uint8, plane-major: all R low
bytes, then the next plane, and so on (little-endian). This is the id
section of the fused frontier rows (`ops/pq_kernels.pack_frontier_rows`).
The JAX package also keeps whole adjacency tables in this form to dodge TPU
lane padding; the port keeps only the row math.
"""

from __future__ import annotations

import torch


def pack_adj_planes(adj_blk: torch.Tensor) -> torch.Tensor:
    """[B, R] int32 -> [B, 4R] u8 plane-major (on the tensor's device)."""
    b, r = adj_blk.shape
    by = adj_blk.to(torch.int32).contiguous().view(torch.uint8)  # [B, 4R] LE
    return by.reshape(b, r, 4).transpose(1, 2).reshape(b, 4 * r)


def decode_adj_planes(rows: torch.Tensor) -> torch.Tensor:
    """[..., 4R] u8 plane-major rows -> [..., R] int32 neighbor ids."""
    r = rows.shape[-1] // 4
    idb = rows.to(torch.int32)
    p0 = idb[..., 0 * r : 1 * r]
    p1 = idb[..., 1 * r : 2 * r]
    p2 = idb[..., 2 * r : 3 * r]
    p3 = idb[..., 3 * r : 4 * r]
    return p0 | (p1 << 8) | (p2 << 16) | (p3 << 24)
