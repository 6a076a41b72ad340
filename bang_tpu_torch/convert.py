"""Carry an index built by the JAX package over to the port.

`index_from_jax` reads the leaves of a `bang_tpu.models.index.DeviceIndex`
as numpy arrays (it needs nothing of JAX itself) and builds the port's
`DeviceIndex` on `device`, for an in-memory (PQ) index or an exact-distance
one (no codebook). Where the JAX index holds a TPU-only layout — byte-plane
adjacency (`adj_planes`) next to neighbor-aligned codes (`nbr_codes`), or
fused PQ or exact rows without an adjacency table — the [N, R] neighbor
ids are decoded back out of it, and the port's own layout is built from
them with the same auto-selection as loading the files.
"""

from __future__ import annotations

import numpy as np

from bang_tpu_torch.models.index import (
    DeviceIndex,
    assemble_device_index,
    assemble_exact_index,
)
from bang_tpu_torch.ops.pq import PQCodebook


def _plane_ids(planes: np.ndarray) -> np.ndarray:
    """[N, 4R] u8 plane-major -> [N, R] int32 (little-endian byte planes)."""
    n, w = planes.shape
    r = w // 4
    return np.ascontiguousarray(
        planes.reshape(n, 4, r).transpose(0, 2, 1)
    ).view("<i4").reshape(n, r)


def adjacency_of(jax_index) -> np.ndarray:
    """The [N, R] int32 neighbor table held in any of the JAX layouts."""
    if jax_index.adj is not None:
        return np.asarray(jax_index.adj, np.int32)
    if jax_index.adj_planes is not None:
        return _plane_ids(np.asarray(jax_index.adj_planes))
    if jax_index.fused_rows is not None:
        rows = np.asarray(jax_index.fused_rows)
        n = rows.shape[0]
        m = np.asarray(jax_index.codes).shape[1]
        if rows.ndim == 3:  # DMA-tiled [N, s, 128]: R=64 rows plus a pad
            rows = rows.reshape(n, -1)[:, : 64 * (4 + m)]
        r = rows.shape[1] // (4 + m)
        return _plane_ids(rows[:, : 4 * r])
    if jax_index.fused_vec_rows is not None:
        rows = np.asarray(jax_index.fused_vec_rows)
        n = rows.shape[0]
        d = np.asarray(jax_index.vectors).shape[1]
        if rows.ndim == 3:  # DMA-tiled [N, s, 128]: R=64 rows plus a pad
            rows = rows.reshape(n, -1)[:, : 64 * (8 + d)]
        r = rows.shape[1] // (8 + d)
        return _plane_ids(rows[:, : 4 * r])
    raise ValueError("the JAX index holds no adjacency in any layout")


def index_from_jax(jax_index, device, fused_frontier: bool | None = None,
                   neighbor_vectors: bool | None = None) -> DeviceIndex:
    """Port-side DeviceIndex on `device` from a JAX in-memory or
    exact-distance DeviceIndex (the latter has no codebook).
    fused_frontier and neighbor_vectors are those of
    models/index.device_index_from_files."""
    if jax_index.vectors is None:
        raise ValueError("index_from_jax needs the vectors (exact distances)")
    if jax_index.codebook is None:
        return assemble_exact_index(
            adjacency_of(jax_index), np.asarray(jax_index.vectors),
            jax_index.medoid, device, fused_frontier, neighbor_vectors,
        )
    if jax_index.codes is None:
        raise ValueError("index_from_jax needs the PQ codes of an in-memory index")
    if neighbor_vectors:
        raise ValueError("neighbor_vectors is a layout of the exactdistance variant")
    cb = jax_index.codebook
    codebook = PQCodebook.from_numpy(
        np.asarray(cb.piv_chunks), np.asarray(cb.piv_norms),
        np.asarray(cb.dim_idx), np.asarray(cb.dim_mask),
        np.asarray(cb.centroid), device,
    )
    return assemble_device_index(
        adjacency_of(jax_index), np.asarray(jax_index.vectors),
        np.asarray(jax_index.codes), codebook, jax_index.medoid, device,
        fused_frontier,
    )
