"""Build and load the package's CUDA kernels (``csrc/*.cu``) for Hopper.

The sources are compiled by ``nvcc`` for ``sm_90a``, one process per source
started together, and linked into one shared library with a plain C
interface, ``build/vbs_torch_kernels/lib<sha16>.so`` under the repository
root, keyed by a hash of the sources and flags, and loaded with ``ctypes``.
Nothing is compiled or loaded at import time: the first CUDA launch calls
:func:`library`. A missing ``nvcc`` or a failed compile raises with the
compiler's output; there is no fallback.

A C entry launches on the runtime's current device, whatever device its
pointers and stream belong to (and ``cudaFuncSetAttribute`` sets a kernel's
shared-memory limit for the current device only), so every wrapper makes
its tensors' device current around the call: a kernel on ``cuda:1`` runs
there while ``cuda:0`` is the thread's device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("fields.cu", "gather.cu", "window_sums.cu", "expand_sorted.cu",
           "displacement_scan.cu", "associate.cu", "filters.cu")
BUILD_DIR = _PKG.parent / "build" / "vbs_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # ncc, area, gray, packed, cval, cidx, B, H, W, thr, band_w, peak_w,
    # open_k, halo, stream
    "vbs_fused_fields": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I,
                         _I, _P),
    # packed, start, out, B, H, W, K, P, pack, stream
    "vbs_gather_windows": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # f0, f1, f2, xy, geom, start, out, B, H, W, K, P, cutoff^2, soft_floor,
    # soft_scale, packed, stream
    "vbs_window_sums": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                        _F, _F, _I, _P),
    # pos, val, n, spill_pos, spill_val, m, out, total, stream
    "vbs_expand_sorted": (_P, _P, _I, _P, _P, _I, _P, _I, _P),
    # world, seen, B, N, max_step, carry in (last, last_ok, first, first_ok,
    # cum), step, step_norm, step_valid, cum_path, from_first,
    # from_first_norm, carry out (5), stream
    "vbs_displacement_scan": (_P, _P, _I, _I, _F, *(_P,) * 5, *(_P,) * 6,
                              *(_P,) * 5, _P),
    # ref_xy, ref_valid, xy, axes, angle, valid, carry, B, N, K, gate,
    # out xy, axes, angle, valid, last, stream
    "vbs_associate_sequential": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                                 _P, _P, _P, _P, _P, _P),
    # src, src_u8, frame stride, row stride, gray, area, count, B, H, W,
    # passes, ka, taps_a, kb, taps_b, offset, thr_lo, thr_hi, stream
    "vbs_dog_fields": (_P, _I, _L, _L, _P, _P, _P, _I, _I, _I, _P, _I, _P,
                       _I, _P, _I, _F, _F, _P),
    # area, ncc, count, mean, B, H, W, passes, k, taps_g, taps_box, inv_hw,
    # inv_n, t0, min_var, tiny, stream
    "vbs_binary_ncc": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _F, _F,
                       _F, _F, _F, _P),
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


def _run(cmd: list[str]) -> str:
    """Run one nvcc command; its output, or raise with it."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{stem}.{Path(name).stem}.o" for name in SOURCES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        log = "".join(pool.map(_run, (
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
            for name, obj in zip(SOURCES, objs))))
    tmp = BUILD_DIR / f"{stem}.tmp.so"
    log += _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
    build_seconds = time.perf_counter() - t0
    build_log = log
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
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
