"""MJPEG helpers (``vision_basedsensor_tpu/io/mjpeg.py``).

Only the SOF scanner is ported so far; the live MJPEG-over-HTTP source
(``MjpegTpuVideoSource`` with ``iter_mjpeg``) is not.
"""
from __future__ import annotations


def sof_dims(jpeg: bytes) -> tuple[int, int] | None:
    """(width, height) from a JPEG's SOF header — a pure-Python marker scan,
    the batch decoder's per-batch geometry sniff (``ops/jpeg.py``). Handles
    APPn/DRI segments via the generic length skip and 0xFF fill bytes
    before markers."""
    i, n = 2, len(jpeg)
    while i + 8 < n:
        if jpeg[i] != 0xFF:
            i += 1
            continue
        m = jpeg[i + 1]
        if m == 0xFF:           # fill-byte padding before a marker
            i += 1
            continue
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m == 0xDA:           # SOS: past the headers, no SOF found
            return None
        if m in (0xC0, 0xC1, 0xC2):
            h = (jpeg[i + 5] << 8) | jpeg[i + 6]
            w = (jpeg[i + 7] << 8) | jpeg[i + 8]
            return w, h
        i += 2 + ((jpeg[i + 2] << 8) | jpeg[i + 3])
    return None
