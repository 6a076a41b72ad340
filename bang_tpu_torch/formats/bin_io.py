"""DiskANN-style flat binary file I/O, copied from bang_tpu/formats/bin_io.py.

Files are the contract between the two packages: these functions write the
same bytes as bang_tpu's and read what it wrote.

File layout ("bin" format, used for base vectors, query sets and PQ codes):
    [int32 npts][int32 dim][row-major data npts*dim of element dtype]
Reference behavior: BANG_Base/bang_search.cuh:287-339 (load_bin_impl).

Truthset layout (ground truth produced by DiskANN compute_groundtruth):
    [int32 npts][int32 k][uint32 ids npts*k][float32 dists npts*k]
Reference behavior: BANG_Inmemory/parANN.h:334-382 (load_truthset).
"""

from __future__ import annotations

import os

import numpy as np


def load_bin(path: str | os.PathLike, dtype) -> np.ndarray:
    """Load a DiskANN bin file as an [npts, dim] array of `dtype`."""
    dtype = np.dtype(dtype)
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype="<i4", count=2)
        npts, dim = int(header[0]), int(header[1])
        expected = npts * dim * dtype.itemsize + 8
        actual = os.fstat(f.fileno()).st_size
        if actual != expected:
            raise ValueError(
                f"{path}: file size mismatch (actual {actual}, expected "
                f"{expected} for npts={npts} dim={dim} dtype={dtype})"
            )
        data = np.fromfile(f, dtype=dtype, count=npts * dim)
    return data.reshape(npts, dim)


def save_bin(path: str | os.PathLike, data: np.ndarray) -> None:
    """Write an [npts, dim] array as a DiskANN bin file."""
    data = np.ascontiguousarray(data)
    if data.ndim != 2:
        raise ValueError(f"bin files hold 2-D row-major data, got {data.ndim}-D")
    with open(path, "wb") as f:
        np.array(data.shape, dtype="<i4").tofile(f)
        data.tofile(f)


def load_truthset(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """Load a DiskANN truthset: returns (ids [npts, k] uint32, dists [npts, k] f32)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype="<i4", count=2)
        npts, k = int(header[0]), int(header[1])
        expected = 2 * npts * k * 4 + 8
        actual = os.fstat(f.fileno()).st_size
        if actual != expected:
            raise ValueError(
                f"{path}: truthset size mismatch (actual {actual}, expected "
                f"{expected} for npts={npts} k={k})"
            )
        ids = np.fromfile(f, dtype="<u4", count=npts * k).reshape(npts, k)
        dists = np.fromfile(f, dtype="<f4", count=npts * k).reshape(npts, k)
    return ids, dists


def save_truthset(path: str | os.PathLike, ids: np.ndarray, dists: np.ndarray) -> None:
    """Write a DiskANN truthset (ids as uint32, dists as f32)."""
    ids = np.ascontiguousarray(ids, dtype="<u4")
    dists = np.ascontiguousarray(dists, dtype="<f4")
    if ids.shape != dists.shape or ids.ndim != 2:
        raise ValueError(f"ids {ids.shape} and dists {dists.shape} must be one 2-D shape")
    with open(path, "wb") as f:
        np.array(ids.shape, dtype="<i4").tofile(f)
        ids.tofile(f)
        dists.tofile(f)
