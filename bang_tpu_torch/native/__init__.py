"""ctypes bindings for the native host gather (port of
bang_tpu/native/__init__.py).

`host_gather.cpp` (a copy of the JAX package's source) is built at first
use with `g++ -O3 -shared -fPIC -pthread` into `bang_tpu_torch/_build/`
(listed in .gitignore), as a library named by a hash of the source, the
compiler and the flags. The build writes a temporary file and moves it into
place with `os.replace`, so concurrent processes (pytest-xdist workers) each
see a whole library or none. There is no fallback: where the JAX module
quietly switches to numpy when the build fails, this one raises with the
compiler's log. `gather_parents_numpy` is the plain version the tests hold
the native gather to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from bang_tpu_torch.constants import DTYPE_CODE_TO_NUMPY

SRC = Path(__file__).resolve().parent / "host_gather.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
RAW_MODE = 3  # dtype_code of the unconverted vector bytes (host_gather.cpp)
# Rows each thread of an automatic thread count gets at least. The library
# starts its threads anew on every call: on the H100 machine's host, 2,500
# rows of 388 B took 0.32 ms on one thread and 3.74 ms on eight, and 20,000
# rows were fastest on four (PERF.md). The JAX package starts one per 256.
ROWS_PER_THREAD = 4096

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"host_gather-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"host gather build failed: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"host gather build failed (rc {res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
    """Build the library if needed and return it, argtypes set."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.bang_gather_parents.restype = None
        lib.bang_gather_parents.argtypes = [
            ctypes.c_void_p,  # index_buf
            ctypes.c_uint64,  # entry_len
            ctypes.c_uint32,  # vec_bytes
            ctypes.c_uint32,  # d
            ctypes.c_uint32,  # r
            ctypes.c_int,  # dtype_code
            ctypes.c_void_p,  # parents
            ctypes.c_int64,  # q
            ctypes.c_void_p,  # out_nbrs
            ctypes.c_void_p,  # out_vecs
            ctypes.c_int,  # n_threads
        ]
        _lib = lib
    return _lib


def _check_out(name, arr, shape, dtype) -> None:
    if not isinstance(arr, np.ndarray) or arr.dtype != dtype or arr.shape != shape:
        raise ValueError(f"{name} must be a {shape} {np.dtype(dtype)} array, got "
                         f"{getattr(arr, 'shape', None)} {getattr(arr, 'dtype', None)}")
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        raise ValueError(f"{name} must be C-contiguous and writeable")


def gather_parents_numpy(
    raw: np.ndarray,
    entry_len: int,
    vec_bytes: int,
    d: int,
    r: int,
    dtype_code: int,
    parents: np.ndarray,
    out_nbrs: np.ndarray,
    out_vecs: np.ndarray | None,
) -> None:
    """Plain numpy version of the native gather over the packed records."""
    recs = raw.reshape(-1, entry_len)[parents]  # [Q, entry_len] u8 copy
    degrees = recs[:, vec_bytes : vec_bytes + 4].copy().view("<u4").reshape(-1)
    nbrs = (
        recs[:, vec_bytes + 4 : vec_bytes + 4 + 4 * r]
        .copy()
        .view("<i4")
        .reshape(-1, r)
    )
    pad = np.arange(r)[None, :] >= np.minimum(degrees, r)[:, None]
    out_nbrs[...] = np.where(pad, parents[:, None].astype(np.int32), nbrs)
    if out_vecs is not None:
        if dtype_code == RAW_MODE:
            out_vecs[...] = recs[:, :vec_bytes]
        else:
            dtype = np.dtype(DTYPE_CODE_TO_NUMPY[dtype_code])
            out_vecs[...] = recs[:, :vec_bytes].copy().view(dtype).astype(np.float32)


def gather_parents(
    raw,
    entry_len,
    vec_bytes,
    d,
    r,
    dtype_code,
    parents,
    n_threads: int = 0,
    raw_vecs: bool = False,
    out_nbrs: np.ndarray | None = None,
    out_vecs: np.ndarray | None = None,
):
    """Gather adjacency rows + parent vectors for a parent batch with the
    native library.

    raw: the packed records, [N, entry_len] u8 (C-contiguous array or
    memmap); parents: [Q] ids in [0, N). Returns (nbrs [Q, r] int32 padded
    with the parent id, vecs): vecs is [Q, d] f32, or with raw_vecs=True
    the UNCONVERTED [Q, vec_bytes] u8 vector bytes (the caller views them as
    the index dtype and casts on the device — 4x less host-to-device traffic
    for u8/i8 data). out_nbrs / out_vecs are
    caller-owned buffers of those shapes (pinned staging tensors' numpy
    views, say) to write into instead of new arrays. n_threads: gather
    threads; 0 picks one per ROWS_PER_THREAD rows, at most one per core and
    32."""
    if not isinstance(raw, np.ndarray) or raw.dtype != np.uint8 or not raw.flags.c_contiguous:
        raise ValueError("raw must be a C-contiguous uint8 array of packed records")
    if vec_bytes + 4 + 4 * r > entry_len:
        raise ValueError(f"records of {entry_len} B cannot hold {vec_bytes} vector "
                         f"bytes, a degree and {r} neighbor ids")
    n = raw.size // entry_len
    parents = np.ascontiguousarray(parents, dtype=np.int32)
    q = len(parents)
    if q and (int(parents.min()) < 0 or int(parents.max()) >= n):
        raise ValueError(f"parents must lie in [0, {n})")
    if n_threads <= 0:
        n_threads = max(1, min(32, os.cpu_count() or 1, q // ROWS_PER_THREAD))
    if out_nbrs is None:
        out_nbrs = np.empty((q, r), dtype=np.int32)
    _check_out("out_nbrs", out_nbrs, (q, r), np.int32)
    shape, dtype = ((q, vec_bytes), np.uint8) if raw_vecs else ((q, d), np.float32)
    if out_vecs is None:
        out_vecs = np.empty(shape, dtype=dtype)
    _check_out("out_vecs", out_vecs, shape, dtype)
    code = RAW_MODE if raw_vecs else dtype_code
    load_library().bang_gather_parents(
        raw.ctypes.data, entry_len, vec_bytes, d, r, code, parents.ctypes.data, q,
        out_nbrs.ctypes.data, out_vecs.ctypes.data, n_threads,
    )
    return out_nbrs, out_vecs
