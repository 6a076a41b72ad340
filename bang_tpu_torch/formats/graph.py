"""Packed Vamana graph index format and its in-memory container, copied from
bang_tpu/formats/graph.py (the reader, the writer and the metadata helpers
they call; the memory-mapped reader of the base variant is not copied).

Files are the contract between the two packages: `save_graph_index` writes
the same bytes as bang_tpu's, and each package reads what the other wrote.

`<prefix>_disk.bin` — N fixed-length records, one per node:
    [vector: dim * dtype_size bytes][degree: uint32][neighbors: R * uint32]
  neighbors are sorted ascending and zero-padded beyond `degree`.
  Record length == metadata.entry_len.
  Reference producer: BANG_Base/bang_preprocess.py:75-110; consumer layout:
  BANG_Base/bang_search.cu:330-346 (record arithmetic).

`<prefix>_disk_metadata.bin` — packed struct, little-endian:
    {uint64 medoid, uint64 entry_len, uint32 dtype_code, uint32 dim,
     uint32 degree, uint32 n}
  Reference: BANG_Base/bang_search.cuh:42-50 (GraphMedataData).

In memory, a struct-of-arrays `GraphIndex`: vectors [N, D], adj [N, R] int32
padded with the node's own id (self-loops are removed by the visited set
during search), degrees [N].
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from bang_tpu_torch.constants import DTYPE_CODE_TO_NUMPY, NUMPY_TO_DTYPE_CODE

GRAPH_INDEX_FILE_SUFFIX = "_disk.bin"
GRAPH_METADATA_FILE_SUFFIX = "_disk_metadata.bin"

_METADATA_STRUCT = struct.Struct("<QQIIII")


@dataclasses.dataclass
class GraphMetadata:
    medoid: int
    entry_len: int
    dtype_code: int
    dim: int
    degree: int
    n: int

    @property
    def numpy_dtype(self) -> np.dtype:
        return np.dtype(DTYPE_CODE_TO_NUMPY[self.dtype_code])


def save_metadata(path: str | os.PathLike, meta: GraphMetadata) -> None:
    with open(path, "wb") as f:
        f.write(
            _METADATA_STRUCT.pack(
                meta.medoid, meta.entry_len, meta.dtype_code, meta.dim, meta.degree, meta.n
            )
        )


def load_metadata(path: str | os.PathLike) -> GraphMetadata:
    with open(path, "rb") as f:
        fields = _METADATA_STRUCT.unpack(f.read(_METADATA_STRUCT.size))
    return GraphMetadata(*fields)


@dataclasses.dataclass
class GraphIndex:
    """Struct-of-arrays graph index (host memory, numpy)."""

    vectors: np.ndarray  # [N, D] of dtype
    adj: np.ndarray  # [N, R] int32, padded with self-id
    degrees: np.ndarray  # [N] int32
    medoid: int

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def r(self) -> int:
        return self.adj.shape[1]

    def metadata(self) -> GraphMetadata:
        dtype_code = NUMPY_TO_DTYPE_CODE[self.vectors.dtype.name]
        entry_len = self.dim * self.vectors.dtype.itemsize + 4 + 4 * self.r
        return GraphMetadata(
            medoid=self.medoid,
            entry_len=entry_len,
            dtype_code=dtype_code,
            dim=self.dim,
            degree=self.r,
            n=self.n,
        )


def save_graph_index(
    prefix: str | os.PathLike, index: GraphIndex, block: int = 4_000_000
) -> None:
    """Write `<prefix>_disk.bin` + `<prefix>_disk_metadata.bin`, streaming
    `block` rows at a time (argsort's int64 temporaries would otherwise
    peak at ~8x the adjacency bytes)."""
    prefix = str(prefix)
    meta = index.metadata()
    n, r = index.n, index.r

    with open(prefix + GRAPH_INDEX_FILE_SUFFIX, "wb") as f:
        for s in range(0, n, block):
            e = min(s + block, n)
            nb = e - s
            vec_bytes = (
                np.ascontiguousarray(index.vectors[s:e]).view(np.uint8).reshape(nb, -1)
            )
            # Neighbor block: sorted valid entries first, zero padding after.
            degrees = index.degrees[s:e].astype(np.int64)
            adj = index.adj[s:e]
            order = np.argsort(
                np.where(
                    np.arange(r)[None, :] < degrees[:, None], adj,
                    np.iinfo(np.int32).max,
                ),
                axis=1,
                kind="stable",
            )
            sorted_adj = np.take_along_axis(adj, order, axis=1).astype("<u4")
            pad_mask = np.arange(r)[None, :] >= degrees[:, None]
            sorted_adj[pad_mask] = 0

            records = np.empty((nb, meta.entry_len), dtype=np.uint8)
            records[:, : vec_bytes.shape[1]] = vec_bytes
            off = vec_bytes.shape[1]
            records[:, off : off + 4] = (
                degrees.astype("<u4")[:, None].view(np.uint8).reshape(nb, 4)
            )
            records[:, off + 4 :] = sorted_adj.view(np.uint8).reshape(nb, 4 * r)
            records.tofile(f)
    save_metadata(prefix + GRAPH_METADATA_FILE_SUFFIX, meta)


def load_graph_index(prefix: str | os.PathLike) -> GraphIndex:
    """Load `<prefix>_disk.bin` + metadata into a GraphIndex; padding past
    each node's degree becomes the node's own id."""
    prefix = str(prefix)
    meta = load_metadata(prefix + GRAPH_METADATA_FILE_SUFFIX)
    path = prefix + GRAPH_INDEX_FILE_SUFFIX
    n, dim, r = meta.n, meta.dim, meta.degree
    dtype = meta.numpy_dtype
    vec_nbytes = dim * dtype.itemsize

    expected = n * meta.entry_len
    actual = os.path.getsize(path)
    if actual < expected:
        raise ValueError(f"{path}: too small ({actual} < {expected}) for metadata {meta}")

    raw = np.fromfile(path, dtype=np.uint8, count=expected).reshape(n, meta.entry_len)
    vectors = np.ascontiguousarray(raw[:, :vec_nbytes].view(dtype))
    degrees = raw[:, vec_nbytes : vec_nbytes + 4].copy().view("<u4").reshape(n).astype(np.int32)
    adj = raw[:, vec_nbytes + 4 :].copy().view("<u4").reshape(n, r).astype(np.int32)

    # Self-ids in the padding: the visited set filters self-loops for free
    # (the parent is always visited when its row is expanded).
    pad_mask = np.arange(r)[None, :] >= degrees[:, None]
    self_ids = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, r))
    adj[pad_mask] = self_ids[pad_mask]

    # Load-time sanity, like the reference's first/last-neighbor asserts
    # (BANG_Base/bang_search.cu:330-346): a corrupt index fails here.
    if n > 0 and (not (0 <= adj[0, 0] < n) or not (0 <= adj[-1, -1] < n)):
        raise ValueError(
            f"{path}: adjacency entries out of range "
            f"(first={adj[0, 0]}, last={adj[-1, -1]}, n={n}) — corrupt index?"
        )

    return GraphIndex(vectors=vectors, adj=adj, degrees=degrees, medoid=meta.medoid)
