"""Build and load the package's CUDA kernels (``csrc/*.cu``) for Hopper.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, ``build/vbs_torch_kernels/lib<sha16>.so`` under the
repository root, keyed by a hash of the sources and flags, and loaded with
``ctypes``. Nothing is compiled or loaded at import time: the first CUDA
launch calls :func:`library`. A missing ``nvcc`` or a failed compile raises
with the compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("fields.cu", "gather.cu")
BUILD_DIR = _PKG.parent / "build" / "vbs_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # ncc, area, gray, packed, cval, cidx, B, H, W, thr, band_w, peak_w,
    # open_k, halo, stream
    "vbs_fused_fields": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I,
                         _I, _P),
    # packed, start, out, B, H, W, K, P, pack, stream
    "vbs_gather_windows": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's compile
build_log: str = ""                  # nvcc/ptxas output of that compile


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of vision_basedsensor_tpu_torch cannot "
                       "be built")


def library_path() -> Path:
    """The shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.vbs_error_string.argtypes = [ctypes.c_int]
        lib.vbs_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        name = library().vbs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
