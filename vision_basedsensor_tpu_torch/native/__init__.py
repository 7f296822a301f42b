"""The native (C++) baseline-JPEG entropy decoder, loaded with ctypes.

Port of ``vision_basedsensor_tpu/native/__init__.py``. ``jpeg_coeffs.cpp`` is
a byte-identical copy of the reference's source (a test compares the two
files' sha256), so the host half of the port's ingest cannot drift from the
JAX package's.

Build: compiled on first use with the system C++ compiler (``$CXX`` or
``g++``) into ``build/vbs_torch_native/`` under the repository root, keyed
by a hash of the source and flags, and published with a temporary file and
``os.replace`` (concurrent builders each write their own temporary). A
missing compiler or a failed compile raises with the compiler's output;
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "jpeg_coeffs.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vbs_torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compiler() -> str:
    for cxx in (os.environ.get("CXX"), "g++"):
        if cxx and shutil.which(cxx):
            return cxx
    raise RuntimeError("no C++ compiler ($CXX or g++) on PATH: the native "
                       "JPEG entropy decoder of vision_basedsensor_tpu_torch "
                       "cannot be built")


def library_path() -> Path:
    """The shared library for the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libvbsjpeg_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [_compiler(), *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native JPEG decoder build failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_jpeg_lib() -> ctypes.CDLL:
    """Compile (once) and load the JPEG entropy decoder."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        P, i32, i64 = ctypes.POINTER, ctypes.c_int, ctypes.c_int64
        u8, i8 = P(ctypes.c_uint8), P(ctypes.c_int8)
        u16, i16 = P(ctypes.c_uint16), P(ctypes.c_int16)
        pi32, pi64 = P(ctypes.c_int32), P(ctypes.c_int64)
        batch = [ctypes.c_char_p, pi64, pi32, i32]   # data, offsets, sizes, n
        tail = [pi64, i32, pi32, u16]                # counts, blocks, meta, q
        sigs = {
            "vbs_jpeg_y_coeffs": [ctypes.c_char_p, i32, i16, i32, pi32, u16],
            "vbs_mjpeg_batch_y_coeffs": batch + [i16, i32, pi32, u16],
            "vbs_mjpeg_batch_y_coeffs_delta": batch + [u8, i8, i64, u8, i16,
                                                       i64] + tail,
            # ac, accap, DC nibble lane, AC spill, DC spill, ..., zmax
            "vbs_mjpeg_batch_y_coeffs_split": batch + [u8, i64, u8, u16, i16,
                                                       i64, u16, i16,
                                                       i64] + tail + [i32],
            "vbs_mjpeg_batch_y_coeffs_tdelta": batch + [u8, i64, u16, i16,
                                                        i64] + tail + [i32],
        }
        for name in ("delta", "split", "tdelta"):   # + worker count
            sigs[f"vbs_mjpeg_batch_y_coeffs_{name}_mt"] = (
                sigs[f"vbs_mjpeg_batch_y_coeffs_{name}"] + [i32])
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
