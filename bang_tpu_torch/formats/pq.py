"""Product-Quantization file formats (DiskANN-compatible), copied from
bang_tpu/formats/pq.py.

Files are the contract between the two packages: these functions write the
same bytes as bang_tpu's and read what it wrote.

`<prefix>_pq_pivots.bin` — a 3-section file with an offset table:
    bytes [0:4]   uint32 = 4          (number of section offsets)
    bytes [4:8]   uint32 = 1          (offset-table column count)
    bytes [8:40]  4 x uint64:         pivots_off, centroid_off,
                                      chunk_offsets_off, total_file_size
    at pivots_off:        [u32 256][u32 D] then 256*D float32 pivot coords
    at centroid_off:      [u32 D][u32 1]   then D float32 centroid
    at chunk_offsets_off: [u32 m+1][u32 1] then (m+1) uint32 chunk offsets
  (chunk c covers dims [off[c], off[c+1]) of the centered space).
  Reference consumer: BANG_Base/bang_search.cu:244-296.

`<prefix>_pq_compressed.bin` — standard bin file of uint8 codes [N, m]:
    [i32 N][i32 m][N*m uint8]
  Reference consumer: BANG_Base/bang_search.cu:216-243.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from bang_tpu_torch.constants import PQ_NUM_CENTERS
from bang_tpu_torch.formats.bin_io import load_bin, save_bin

PQ_PIVOTS_FILE_SUFFIX = "_pq_pivots.bin"
PQ_COMPRESSED_FILE_SUFFIX = "_pq_compressed.bin"


@dataclasses.dataclass
class PQData:
    """PQ codebook + codes.

    pivots: [256, D] float32 — per-chunk codebooks packed into full-dim rows;
            chunk c's 256 centers live in columns [offsets[c], offsets[c+1]).
    centroid: [D] float32 — subtracted from data/queries before encoding.
    chunk_offsets: [m+1] uint32.
    codes: [N, m] uint8 (None when only the codebook is loaded).
    """

    pivots: np.ndarray
    centroid: np.ndarray
    chunk_offsets: np.ndarray
    codes: np.ndarray | None = None

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_offsets) - 1

    @property
    def dim(self) -> int:
        return self.pivots.shape[1]


def save_pq_pivots(path: str | os.PathLike, pq: PQData) -> None:
    d = pq.dim
    m = pq.num_chunks
    if pq.pivots.shape != (PQ_NUM_CENTERS, d):
        raise ValueError(f"pivots must be [{PQ_NUM_CENTERS}, D], got {pq.pivots.shape}")
    header_end = 8 + 4 * 8
    pivots_off = header_end
    centroid_off = pivots_off + 8 + PQ_NUM_CENTERS * d * 4
    chunk_off_off = centroid_off + 8 + d * 4
    total = chunk_off_off + 8 + (m + 1) * 4
    with open(path, "wb") as f:
        f.write(struct.pack("<II", 4, 1))
        f.write(struct.pack("<QQQQ", pivots_off, centroid_off, chunk_off_off, total))
        f.write(struct.pack("<II", PQ_NUM_CENTERS, d))
        np.ascontiguousarray(pq.pivots, dtype="<f4").tofile(f)
        f.write(struct.pack("<II", d, 1))
        np.ascontiguousarray(pq.centroid, dtype="<f4").tofile(f)
        f.write(struct.pack("<II", m + 1, 1))
        np.ascontiguousarray(pq.chunk_offsets, dtype="<u4").tofile(f)


def load_pq_pivots(path: str | os.PathLike) -> PQData:
    with open(path, "rb") as f:
        nsec, _ = struct.unpack("<II", f.read(8))
        if nsec != 4:
            raise ValueError(f"{path}: expected 4 section offsets, got {nsec}")
        pivots_off, centroid_off, chunk_off_off, _total = struct.unpack("<QQQQ", f.read(32))

        f.seek(pivots_off)
        rows, d = struct.unpack("<II", f.read(8))
        if rows != PQ_NUM_CENTERS:
            raise ValueError(f"{path}: expected {PQ_NUM_CENTERS} pivots, got {rows}")
        pivots = np.fromfile(f, dtype="<f4", count=rows * d).reshape(rows, d)

        f.seek(centroid_off)
        cd, _ = struct.unpack("<II", f.read(8))
        centroid = np.fromfile(f, dtype="<f4", count=cd)

        f.seek(chunk_off_off)
        mm1, _ = struct.unpack("<II", f.read(8))
        chunk_offsets = np.fromfile(f, dtype="<u4", count=mm1)

    return PQData(pivots=pivots, centroid=centroid, chunk_offsets=chunk_offsets)


def save_pq_compressed(path: str | os.PathLike, codes: np.ndarray) -> None:
    save_bin(path, np.ascontiguousarray(codes, dtype=np.uint8))


def load_pq_compressed(path: str | os.PathLike) -> np.ndarray:
    return load_bin(path, np.uint8)


def load_pq(prefix: str | os.PathLike) -> PQData:
    """Load both PQ files for an index prefix."""
    prefix = str(prefix)
    pq = load_pq_pivots(prefix + PQ_PIVOTS_FILE_SUFFIX)
    pq.codes = load_pq_compressed(prefix + PQ_COMPRESSED_FILE_SUFFIX)
    return pq


def save_pq(prefix: str | os.PathLike, pq: PQData) -> None:
    prefix = str(prefix)
    save_pq_pivots(prefix + PQ_PIVOTS_FILE_SUFFIX, pq)
    if pq.codes is not None:
        save_pq_compressed(prefix + PQ_COMPRESSED_FILE_SUFFIX, pq.codes)
