"""TexMex corpus vector formats, fvecs / bvecs / ivecs (numpy copy of
bang_tpu/formats/texmex.py over the port's own bin_io).

The public ANN datasets the reference benchmarks on ship in these formats:
SIFT1M / GIST1M (corpus-texmex.irisa.fr) as fvecs+ivecs, SIFT1B (BigANN) as
bvecs. Each record is `<int32 dim><dim elements>`; dim repeats per record.
DiskANN converts them to its `.bin` layout (`<int32 n><int32 dim><data>`)
before indexing; `to_bin` is that conversion, so a downloaded dataset flows
straight into the loaders (formats/bin_io.py).

Readers take a `count` bound and memory-map: a 1B-point bvecs file is 132 GB
and must be sliced, not loaded.
"""

from __future__ import annotations

import os

import numpy as np

from bang_tpu_torch.formats.bin_io import save_truthset

_ELEM = {".fvecs": (np.float32, 4), ".bvecs": (np.uint8, 1), ".ivecs": (np.int32, 4)}


def _record_layout(path: str) -> tuple[np.dtype, int, int]:
    """(element dtype, element size, dim) from the extension + first record."""
    ext = os.path.splitext(path)[1]
    if ext not in _ELEM:
        raise ValueError(f"unknown TexMex extension {ext!r} (fvecs/bvecs/ivecs)")
    dtype, esize = _ELEM[ext]
    with open(path, "rb") as f:
        dim = int(np.fromfile(f, dtype="<i4", count=1)[0])
    if not (0 < dim <= 100_000):
        raise ValueError(f"{path}: implausible record dim {dim}")
    return np.dtype(dtype), esize, dim


def read_vecs(path: str, count: int | None = None, offset: int = 0) -> np.ndarray:
    """Read records [offset, offset+count) of a TexMex vecs file -> [n, dim]."""
    dtype, esize, dim = _record_layout(path)
    rec_bytes = 4 + dim * esize
    total = os.path.getsize(path) // rec_bytes
    if os.path.getsize(path) % rec_bytes:
        raise ValueError(f"{path}: size not a multiple of the record size")
    n = total - offset if count is None else min(count, total - offset)
    if n <= 0:
        return np.empty((0, dim), dtype)
    raw = np.memmap(path, dtype=np.uint8, mode="r",
                    offset=offset * rec_bytes, shape=(n, rec_bytes))
    dims = raw[:, :4].copy().view("<i4")[:, 0]
    if (dims != dim).any():
        raise ValueError(f"{path}: inconsistent record dims")
    return raw[:, 4:].copy().view(dtype).reshape(n, dim)


def to_bin(vecs_path: str, bin_path: str, count: int | None = None,
           block: int = 1_000_000) -> tuple[int, int]:
    """Convert a TexMex vecs file to DiskANN `.bin`, streaming in blocks.
    Returns (n, dim)."""
    _, esize, dim = _record_layout(vecs_path)
    rec_bytes = 4 + dim * esize
    total = os.path.getsize(vecs_path) // rec_bytes
    n = total if count is None else min(count, total)
    with open(bin_path, "wb") as f:
        np.asarray([n, dim], dtype="<i4").tofile(f)
        for s in range(0, n, block):
            f.write(read_vecs(vecs_path, count=min(block, n - s), offset=s).tobytes())
    return n, dim


def groundtruth_to_truthset(ivecs_path: str, out_path: str,
                            dists_fvecs_path: str | None = None) -> None:
    """TexMex ivecs ground truth -> the reference's truthset bin
    (`<n><k><n*k u32 ids><n*k f32 dists>`; distances zero-filled when the
    corpus provides none — recall with tie-expansion needs them, so pass the
    companion _groundtruth_distances fvecs when there is one)."""
    ids = read_vecs(ivecs_path).astype(np.uint32)
    if dists_fvecs_path is not None:
        dists = read_vecs(dists_fvecs_path).astype(np.float32)
    else:
        dists = np.zeros(ids.shape, np.float32)
    save_truthset(out_path, ids, dists)
