"""The port's native (C++) host code, loaded with ctypes: two libraries.

- The baseline-JPEG entropy decoder, ``jpeg_coeffs.cpp``, ported from
  ``vision_basedsensor_tpu/native/__init__.py``: a byte-identical copy of the
  reference's source (a test compares the two files' sha256), so the host
  half of the port's ingest cannot drift from the JAX package's.
- The tracking CSV's row formatter, ``table_format.cpp``, the port's own:
  ``io/table.py:write_tracking_csv`` formats the whole table in one call and
  writes the bytes the JAX package's row-by-row writer writes.
  :func:`table_format_counts` reads its rows and wide values.

Build: each library is compiled on first use with the system C++ compiler
(``$CXX`` or ``g++``) into ``build/vbs_torch_native/`` under the repository
root, keyed by a hash of its source and the flags, and published with a
temporary file and ``os.replace`` (concurrent builds each write their own
temporary). A missing compiler or a failed compile raises with the
compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "jpeg_coeffs.cpp"
_TABLE_SRC = _HERE / "table_format.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vbs_torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_table_lib: ctypes.CDLL | None = None
# The table formatter's counts since the process started: rows written and
# values that took its wide (non-finite or |x| >= 2**53) path.
_table_counts = {"rows": 0, "wide_values": 0}


def _compiler(what: str) -> str:
    for cxx in (os.environ.get("CXX"), "g++"):
        if cxx and shutil.which(cxx):
            return cxx
    raise RuntimeError(f"no C++ compiler ($CXX or g++) on PATH: the {what} "
                       "of vision_basedsensor_tpu_torch cannot be built")


def _library_path(src: Path, stem: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _build_library(src: Path, out: Path, what: str) -> Path:
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [_compiler(what), *CXX_FLAGS, str(src), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library_path() -> Path:
    """The JPEG decoder's shared library for the current source and flags."""
    return _library_path(_SRC, "libvbsjpeg")


def table_library_path() -> Path:
    """The table formatter's shared library for its source and the flags."""
    return _library_path(_TABLE_SRC, "libvbstable")


def _build() -> Path:
    return _build_library(_SRC, library_path(), "native JPEG decoder")


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


def load_table_lib() -> ctypes.CDLL:
    """Compile (once) and load the tracking CSV's row formatter."""
    global _table_lib
    with _lock:
        if _table_lib is not None:
            return _table_lib
        lib = ctypes.CDLL(str(_build_library(
            _TABLE_SRC, table_library_path(), "native table formatter")))
        P, i64 = ctypes.POINTER, ctypes.c_int64
        lib.vbs_table_bound.argtypes = [P(ctypes.c_double), i64]
        lib.vbs_table_bound.restype = i64
        lib.vbs_table_format.argtypes = [P(i64), P(ctypes.c_double), i64,
                                         P(ctypes.c_char), i64, P(i64)]
        lib.vbs_table_format.restype = i64
        _table_lib = lib
        return lib


def format_table_rows(ints: np.ndarray, vals: np.ndarray) -> memoryview:
    """The tracking CSV's rows as bytes: ``ints`` (n, 4) int64 written as
    integers and ``vals`` (n, 7) float64 as Python's ``'%.4f'``, comma
    separated, each row ended by ``\\r\\n``."""
    n = ints.shape[0]
    if (ints.dtype != np.int64 or vals.dtype != np.float64
            or ints.shape != (n, 4) or vals.shape != (n, 7)
            or not ints.flags.c_contiguous or not vals.flags.c_contiguous):
        raise ValueError(f"rows must be C-contiguous int64 (n, 4) and "
                         f"float64 (n, 7), not {ints.dtype} {ints.shape} and "
                         f"{vals.dtype} {vals.shape}")
    lib = load_table_lib()
    P = ctypes.POINTER
    pv = vals.ctypes.data_as(P(ctypes.c_double))
    out = np.empty(lib.vbs_table_bound(pv, n), np.uint8)
    wide = ctypes.c_int64()
    size = lib.vbs_table_format(ints.ctypes.data_as(P(ctypes.c_int64)), pv, n,
                                out.ctypes.data_as(P(ctypes.c_char)),
                                out.size, ctypes.byref(wide))
    if size < 0:
        raise RuntimeError("native table formatter: the row bound was short")
    _table_counts["rows"] += n
    _table_counts["wide_values"] += wide.value
    return memoryview(out)[:size]


def table_format_counts() -> dict:
    """The table formatter's rows and wide values since the process
    started."""
    return dict(_table_counts)
