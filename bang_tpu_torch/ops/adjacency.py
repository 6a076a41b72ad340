"""Byte-plane neighbor ids (port of bang_tpu/ops/adjacency.py).

An [N, R] int32 neighbor table as [N, 4R] uint8, plane-major: all R low
bytes, then the next plane, and so on (little-endian). This is the id
section of the fused frontier rows (`ops/pq_kernels.pack_frontier_rows`)
and the adjacency of the neighbor-aligned code layout (`adj_planes`,
models/index.py), which holds it in place of the [N, R] int32 table as the
JAX package does: one row gather of 4R bytes a parent, then the shift-or
decode. The JAX package picked the form to dodge TPU lane padding; on the
card it is simply the layout that the neighbor-aligned index carries.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_adj_planes_np(adj: np.ndarray) -> np.ndarray:
    """[N, R] int32 -> [N, 4R] u8 plane-major (host-side numpy)."""
    n, r = adj.shape
    return (
        np.ascontiguousarray(adj, dtype=np.int32)
        .view(np.uint8).reshape(n, r, 4).transpose(0, 2, 1).reshape(n, 4 * r)
    )


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


class PlaneAdjacency:
    """Callable adjacency for the traversal (models/traversal.make_step):
    one row gather of the parents' u8 plane rows, then the shift-or decode.
    Takes the place of an [N, R] int32 table (`[parents] -> ids`)."""

    def __init__(self, planes: torch.Tensor):
        self.planes = planes  # [N, 4R] u8
        self.r = planes.shape[1] // 4

    def __call__(self, parents: torch.Tensor) -> torch.Tensor:
        q = parents.shape[0]
        rows = self.planes[parents.long()]  # [Q, P, 4R] u8 — ONE row gather
        return decode_adj_planes(rows).reshape(q, -1)  # [Q, P*R] i32


class FrontierOnlyAdj:
    """Adjacency stand-in for fused-frontier indexes: the fused rows carry
    the neighbor ids, so no adjacency table is resident. make_step reads
    only `.r` when a frontier_fn is attached and never calls it (the port's
    searches pass None there and make_step reads `distance_fn.r`; the
    class is JAX's, for code written against its contract)."""

    def __init__(self, r: int):
        self.r = r

    def __call__(self, parents):  # pragma: no cover - unreachable by design
        raise RuntimeError(
            "fused-frontier index has no adjacency table; the traversal must "
            "use distance_fn.frontier_fn"
        )
