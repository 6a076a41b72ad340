"""Build the CUDA kernels under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C entry point `<name>_launch` that takes
device pointers (`tensor.data_ptr()`), int shapes and the CUDA stream, and
returns `cudaGetLastError()` as an int. No PyTorch header is included, so a
build takes seconds, not minutes.

The build runs at first use into `bang_tpu_torch/_build/` (listed in
.gitignore), one shared library per source, named by a hash of the source,
the shared headers (`csrc/*.cuh`) and the flags: a changed source or header
rebuilds, an unchanged one is loaded as is.
`build_libraries` starts one nvcc per missing source, all at once, so
several kernels build in the time of the slowest. nvcc is found through
`torch.utils.cpp_extension.CUDA_HOME`.

Also here: the argument checks and the device routing that the kernel
wrappers share (`check_tensor`, `check_packed`, `check_aligned`, `route`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target,
# which later kernels of this package will want.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each kernel's entry point: (argtypes) -> int cudaError_t
SIGNATURES = {
    "pq_lookup": (_P, _P, _P, _I, _I, _I, _P),
    "frontier_lookup": (_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P),
    "exact_frontier": (_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P),
    "lookup_packed": (_P, _P, _P, _I, _I, _I, _P),
    "frontier_packed": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "row_gather": (_P, _P, _P, ctypes.c_longlong, _I, ctypes.c_longlong, _P),
}

# An H100 block can use at most 227 KB (232,448 bytes) of shared memory.
MAX_SHARED_BYTES = 232_448
# Kernels over bf16-pair tables stage one query's m x 128 int32 table there.
MAX_PACKED_CHUNKS = MAX_SHARED_BYTES // (128 * 4)  # 454

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, dict] = {}  # name -> {"seconds", "cached", "log"}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (torch.utils.cpp_extension.CUDA_HOME is "
            "None); the port's kernels need nvcc"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def nvcc_command(src: str | os.PathLike, out: str | os.PathLike,
                 nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that builds `src` into the shared library `out`."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_nvcc(name: str):
    """Start nvcc for `csrc/<name>.cu` into a temporary file; returns
    (process, temporary path, command)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = nvcc_command(SRC_DIR / f"{name}.cu", tmp, nvcc_path())
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, cmd


def _finish_nvcc(name: str, proc, tmp, cmd) -> str:
    """Wait for one nvcc, move its library into place; returns its log."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, library_path(name))  # atomic: a concurrent loader sees all or nothing
    return log


def _load(name: str, seconds: float, cached: bool, log: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(SIGNATURES[name])
    fn.restype = ctypes.c_int
    err_str = getattr(lib, f"{name}_error_string")
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    BUILD_INFO[name] = {"seconds": seconds, "cached": cached, "log": log}
    _LOADED[name] = lib
    return lib


def build_libraries(names) -> None:
    """Build and load every kernel in `names` that is not loaded yet: one
    nvcc per missing library, all started together, then all awaited."""
    todo = [n for n in names if n not in _LOADED]
    t0 = time.perf_counter()
    started = {}
    try:
        for n in todo:
            if not library_path(n).exists():
                started[n] = _start_nvcc(n)
        logs = {n: _finish_nvcc(n, *job) for n, job in started.items()}
    finally:
        for proc, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t0
    for n in todo:
        _load(n, secs, n not in started, logs.get(n, ""))


def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if needed and return the loaded library, with
    `<name>_launch`'s argtypes and restype set."""
    if name not in _LOADED:
        build_libraries([name])
    return _LOADED[name]


def check_launch(name: str, err: int) -> None:
    """Raise if `<name>_launch` returned a CUDA error."""
    if err != 0:
        msg = getattr(_LOADED[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def check_tensor(name, t, dtype, ndim) -> None:
    """Raise unless `t` is a contiguous `ndim`-d tensor of `dtype`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(
            f"{name} must be a {ndim}-d {dtype} tensor, got {t.ndim}-d {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_packed(packed) -> tuple[int, int]:
    """Raise unless `packed` is a [Q, m, 128] int32 bf16-pair table
    (ops/pq.pack_tables) whose m x 128 words fit in shared memory; returns
    (Q, m)."""
    check_tensor("packed", packed, torch.int32, 3)
    q, m, w = packed.shape
    if w != 128:
        raise ValueError(f"packed must be [Q, m, 128], got {tuple(packed.shape)}")
    if not 1 <= m <= MAX_PACKED_CHUNKS:
        raise ValueError(
            f"m={m} chunks: the kernel stages an m x 128 int32 table in shared "
            f"memory and takes 1 <= m <= {MAX_PACKED_CHUNKS}"
        )
    return q, m


def check_aligned(packed) -> None:
    """Raise unless `packed` starts on a 16-byte boundary: the kernels
    stage packed tables with 16-byte loads."""
    if packed.data_ptr() % 16:
        raise ValueError("packed must start on a 16-byte boundary")


def route(*tensors) -> str:
    """'cpu' or 'cuda' for tensors that all sit on one device; raise else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type
