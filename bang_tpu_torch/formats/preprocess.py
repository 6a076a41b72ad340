"""Offline preprocessing: DiskANN `_disk.index` → packed graph + metadata
(the port's copy of bang_tpu/formats/preprocess.py; the same bytes out).

Functional equivalent of the reference's converter
(BANG_Base/bang_preprocess.py, BANG_*/utils/index_to_binary_graph.py), written
as a vectorized library function + CLI rather than a per-byte loop.

DiskANN `_disk.index` layout (sector size 4096):
  sector 0 (metadata): [i32, i32] then uint64 fields:
      npts, ndims, medoid, max_node_len, nnodes_per_sector,
      <3 skipped uint64s>, file_size
  sectors 1..: `nnodes_per_sector` node records per sector, each:
      [vector: dim * dtype_size][degree u32][neighbor ids: degree u32]
      padded to max_node_len.

Output: `<prefix>_disk.bin` with records [vector][degree][R sorted neighbors
(zero-padded)] and `<prefix>_disk_metadata.bin` (see formats/graph.py).
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np

from bang_tpu_torch.constants import DTYPE_CODE_TO_NUMPY
from bang_tpu_torch.formats.graph import (
    GraphIndex,
    GraphMetadata,
    save_graph_index,
)

SECTOR_LEN = 4096


def read_diskann_index(
    path: str | os.PathLike, dim: int, dtype_code: int, degree: int
) -> tuple[GraphIndex, GraphMetadata]:
    """Parse a DiskANN `_disk.index` file into a GraphIndex."""
    dtype = np.dtype(DTYPE_CODE_TO_NUMPY[dtype_code])
    with open(path, "rb") as f:
        f.read(8)  # two i32s
        npts, ndims, medoid, max_node_len, nodes_per_sector = struct.unpack(
            "<QQQQQ", f.read(40)
        )
        f.read(24)  # three skipped uint64 fields
        (file_size,) = struct.unpack("<Q", f.read(8))
    if ndims != dim:
        raise ValueError(f"dim mismatch: file says {ndims}, caller says {dim}")

    vec_nbytes = dim * dtype.itemsize
    n_sectors = file_size // SECTOR_LEN - 1
    raw = np.memmap(path, dtype=np.uint8, mode="r")

    vectors = np.empty((npts, dim), dtype=dtype)
    degrees = np.empty(npts, dtype=np.int32)
    adj = np.zeros((npts, degree), dtype=np.int32)

    node = 0
    for s in range(int(n_sectors)):
        base = (s + 1) * SECTOR_LEN
        count = min(int(nodes_per_sector), npts - node)
        if count <= 0:
            break
        sector = raw[base : base + count * max_node_len]
        recs = np.asarray(sector).reshape(count, int(max_node_len))
        vectors[node : node + count] = recs[:, :vec_nbytes].view(dtype)
        deg = recs[:, vec_nbytes : vec_nbytes + 4].copy().view("<u4").reshape(count)
        degrees[node : node + count] = deg
        nbr_block = (
            recs[:, vec_nbytes + 4 : vec_nbytes + 4 + 4 * degree]
            .copy()
            .view("<u4")
            .reshape(count, degree)
            .astype(np.int32)
        )
        adj[node : node + count] = nbr_block
        node += count
    if node != npts:
        raise ValueError(f"read {node} nodes, expected {npts}")

    # Sort valid neighbors ascending, pad with self id (the reference sorts and
    # zero-pads; self-padding is our search-time convention — save_graph_index
    # re-derives zero padding from `degrees` when writing).
    col = np.arange(degree)[None, :]
    valid = col < degrees[:, None]
    keyed = np.where(valid, adj, np.iinfo(np.int32).max)
    adj = np.take_along_axis(adj, np.argsort(keyed, axis=1, kind="stable"), axis=1)
    self_ids = np.broadcast_to(np.arange(npts, dtype=np.int32)[:, None], adj.shape)
    adj = np.where(valid, adj, self_ids)

    index = GraphIndex(vectors=vectors, adj=adj, degrees=degrees, medoid=int(medoid))
    meta = GraphMetadata(
        medoid=int(medoid),
        entry_len=vec_nbytes + 4 + 4 * degree,
        dtype_code=dtype_code,
        dim=dim,
        degree=degree,
        n=int(npts),
    )
    return index, meta


def convert_diskann_index(
    index_path: str | os.PathLike,
    out_prefix: str | os.PathLike,
    dim: int,
    dtype_code: int,
    degree: int,
) -> GraphMetadata:
    """`_disk.index` → `<out_prefix>_disk.bin` + `<out_prefix>_disk_metadata.bin`."""
    index, meta = read_diskann_index(index_path, dim, dtype_code, degree)
    save_graph_index(out_prefix, index)
    return meta


def preprocess_data_mips(data: np.ndarray) -> np.ndarray:
    """MIPS data transform: append sqrt(M^2 - |x|^2) (M = max norm).

    With queries transformed by `preprocess_queries_mips`, squared L2 in the
    augmented space is 1 + M^2 - 2 <x, q>/|q| — monotone decreasing in the
    inner product — so L2 graph search returns maximum-inner-product
    neighbors. (DiskANN's standard MIPS reduction; the reference applies it
    offline before index build, README.md / test_driver.cpp:280-336.)
    """
    x = data.astype(np.float32)
    norms_sq = (x * x).sum(1, keepdims=True)
    m_sq = norms_sq.max()
    extra = np.sqrt(np.maximum(m_sq - norms_sq, 0.0))
    return np.concatenate([x, extra], axis=1)


def preprocess_queries_mips(queries: np.ndarray) -> np.ndarray:
    """MIPS query transform: L2-normalize and append a zero dimension.

    Matches the reference's preprocess mode (BANG_Base/test_driver.cpp:280-336):
    with data points augmented by sqrt(M^2 - |x|^2), L2 search over the
    augmented space returns maximum-inner-product neighbors.
    """
    q = queries.astype(np.float32)
    norms = np.linalg.norm(q, axis=1, keepdims=True)
    norms = np.where(norms == 0, 1.0, norms)
    q = q / norms
    return np.concatenate([q, np.zeros((q.shape[0], 1), np.float32)], axis=1)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="DiskANN _disk.index -> packed bin + metadata")
    c.add_argument("index_file", help="DiskANN _disk.index path")
    c.add_argument("out_bin", help="output _disk.bin path (prefix derived from it)")
    c.add_argument("dim", type=int)
    c.add_argument("dtype", type=int, help="0=int8 1=uint8 2=float32")
    c.add_argument("degree", type=int)

    # reference: test_driver preprocess mode (argc==3) normalizes MIPS queries
    # and appends the zero dimension (test_driver.cpp:566-571, 280-336)
    q = sub.add_parser("mips-queries", help="normalize queries + append 0 dim")
    q.add_argument("in_bin")
    q.add_argument("out_bin")

    args = p.parse_args(argv)
    if args.cmd == "convert":
        out = args.out_bin
        prefix = out[: -len("_disk.bin")] if out.endswith("_disk.bin") else out
        meta = convert_diskann_index(
            args.index_file, prefix, args.dim, args.dtype, args.degree
        )
        print(f"converted: {meta}")
    else:
        from bang_tpu_torch.formats.bin_io import load_bin, save_bin

        queries = load_bin(args.in_bin, np.float32)
        save_bin(args.out_bin, preprocess_queries_mips(queries))
        print(f"wrote {args.out_bin}: {queries.shape[0]} queries, dim+1")


if __name__ == "__main__":
    main()
