"""Build the CUDA kernels under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C entry point `<name>_launch` that takes
device pointers (`tensor.data_ptr()`), int shapes and the CUDA stream, and
returns `cudaGetLastError()` as an int. No PyTorch header is included, so a
build takes seconds, not minutes.

The build runs at first use into `bang_tpu_torch/_build/` (listed in
.gitignore), one shared library per source, named by a hash of the source
and the flags: a changed source rebuilds, an unchanged one is loaded as is.
nvcc is found through `torch.utils.cpp_extension.CUDA_HOME`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

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
}

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
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if needed and return the loaded library, with
    `<name>_launch`'s argtypes and restype set."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    t0 = time.perf_counter()
    log = ""
    cached = out.exists()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(SRC_DIR / f"{name}.cu", tmp, nvcc_path())
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (rc {res.returncode}):\n"
                f"{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(SIGNATURES[name])
    fn.restype = ctypes.c_int
    err_str = getattr(lib, f"{name}_error_string")
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    BUILD_INFO[name] = {
        "seconds": time.perf_counter() - t0, "cached": cached, "log": log,
    }
    _LOADED[name] = lib
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if `<name>_launch` returned a CUDA error."""
    if err != 0:
        msg = getattr(_LOADED[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
