"""A baseline JPEG encoder for gray frames (numpy only) and an MJPEG
``.avi`` muxer: frozen copies of the port's ``io/jpeg_encode.py`` and
``io/video.py:MjpegAviWriter``.

Baseline sequential DCT (SOF0), 8-bit, one component, 8x8 blocks, the
Annex K luma quantization table scaled by the IJG quality formula and the
Annex K luma DC/AC Huffman tables (ITU-T T.81). The muxer wraps the JPEG
payloads verbatim in a minimal RIFF/AVI container (avih + one MJPG 'vids'
stream + movi + idx1), as the sensor's recorder stores its stream.
"""
from __future__ import annotations

import functools
import struct

import numpy as np

# Annex K.1, luma quantization table, natural order.
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
# Natural index of each zigzag scan position (T.81 figure A.6).
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.3, luma DC and AC tables: code counts per length 1..16, symbols.
_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
_DC_VALS = tuple(range(12))
_AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9"
    "fa")


def quant_table(quality: int) -> np.ndarray:
    """The Annex K luma table scaled by the IJG quality formula (libjpeg's
    ``jpeg_quality_scaling``), clamped to baseline's [1, 255]."""
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be in [1, 100], got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((_LUMA_Q * scale + 50) // 100, 1, 255)


@functools.cache
def _huffman(bits: tuple, vals: tuple) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes (T.81 Annex C): ``(code, length)`` per symbol."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]], size[vals[k]] = c, length
            c += 1
            k += 1
        c <<= 1
    return code, size


@functools.cache
def _dct_basis() -> np.ndarray:
    """A[i, k] = alpha(k) cos((2i+1) k pi / 16): coefficients = A^T X A."""
    i = np.arange(8)[:, None]
    k = np.arange(8)
    return (np.cos((2 * i + 1) * k * np.pi / 16.0)
            * np.where(k == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0)))


def _category(v: np.ndarray) -> np.ndarray:
    """Bits needed for |v| (0 for 0): the JPEG magnitude category."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _extra_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The category's extra bits: v, or v - 1 in s bits when negative."""
    return np.where(v < 0, v + (np.int64(1) << s) - 1, v)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def _dht(cls_id: int, bits: tuple, vals) -> bytes:
    return _segment(0xC4, bytes([cls_id]) + bytes(bits) + bytes(vals))


def encode_jpeg(gray: np.ndarray, quality: int = 70
                ) -> tuple[bytes, np.ndarray]:
    """Baseline JPEG bytes of a ``(H, W)`` uint8 gray frame, and its
    quantized coefficients ``(bh * bw, 64)`` int16 in zigzag order, block
    rows in raster order (what a decoder's entropy stage recovers)."""
    gray = np.asarray(gray)
    if gray.ndim != 2 or gray.dtype != np.uint8:
        raise ValueError(f"expected a (H, W) uint8 frame, got {gray.dtype} "
                         f"{gray.shape}")
    h, w = gray.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"frame size {w}x{h} outside baseline JPEG's range")
    q = quant_table(quality)
    bh, bw = -(-h // 8), -(-w // 8)
    # Edge replication, as libjpeg pads partial blocks.
    x = np.pad(gray, ((0, 8 * bh - h), (0, 8 * bw - w)), mode="edge")
    x = x.astype(np.float64).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
    a = _dct_basis()
    c = (a.T @ x @ a).reshape(bh * bw, 64)
    # Quantize, rounding half away from zero (libjpeg's descale).
    zz = (np.sign(c) * np.floor(np.abs(c) / q + 0.5)).astype(np.int64)
    zz = np.clip(zz[:, _ZIGZAG], -1023, 1023)   # AC category <= 10

    nblk = bh * bw
    dc_code, dc_size = _huffman(_DC_BITS, _DC_VALS)
    ac_code, ac_size = _huffman(_AC_BITS, tuple(_AC_VALS))
    # DC: difference to the previous block's DC (raster order), category
    # code then the extra bits, as one word.
    diff = np.diff(zz[:, 0], prepend=0)
    s = _category(diff)
    dc_word = (dc_code[s] << s) | _extra_bits(diff, s)
    dc_len = dc_size[s] + s
    # AC: each nonzero coefficient, after its run of zeros: one ZRL (16
    # zeros) per full 16, then the (run, size) symbol and the extra bits,
    # as one word of at most 3 * 11 + 16 + 10 = 59 bits.
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    first = np.ones(blk.size, bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    nzrl, run = run // 16, run % 16
    s = _category(v)
    sym = (run << 4) | s
    zrl_c, zrl_s = ac_code[0xF0], ac_size[0xF0]
    word = np.zeros(blk.size, np.int64)
    length = np.zeros(blk.size, np.int64)
    for i in range(3):
        has = nzrl > i
        word = np.where(has, (word << zrl_s) | zrl_c, word)
        length = length + np.where(has, zrl_s, 0)
    word = (((word << ac_size[sym]) | ac_code[sym]) << s) | _extra_bits(v, s)
    length = length + ac_size[sym] + s
    # EOB after a block whose last nonzero is before zigzag index 63.
    last = np.zeros(nblk, np.int64)
    last[blk] = k   # k increases within a block: the last write wins
    eob = np.nonzero(last < 63)[0]
    # Order: per block, DC (key 0), ACs (key = zigzag index), EOB (key 64).
    keys = np.concatenate([np.arange(nblk) * 65, blk * 65 + k, eob * 65 + 64])
    order = np.argsort(keys, kind="stable")
    words = np.concatenate([dc_word, word,
                            np.full(eob.size, ac_code[0x00])])[order]
    lens = np.concatenate([dc_len, length,
                           np.full(eob.size, ac_size[0x00])])[order]
    # Bit packing, MSB first; the last byte is padded with 1-bits.
    total = int(lens.sum())
    idx = np.repeat(np.arange(words.size), lens)
    within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = ((words[idx] >> (lens[idx] - 1 - within)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    data = np.packbits(bits)
    # Byte stuffing: a 0x00 after every 0xFF of entropy-coded data.
    ff = np.nonzero(data == 0xFF)[0]
    data = np.insert(data, ff + 1, 0)

    header = (b"\xff\xd8"
              + _segment(0xDB, bytes([0]) + bytes(q[_ZIGZAG].astype(np.uint8)))
              + _segment(0xC0, bytes([8]) + h.to_bytes(2, "big")
                         + w.to_bytes(2, "big") + bytes([1, 1, 0x11, 0]))
              + _dht(0x00, _DC_BITS, _DC_VALS)
              + _dht(0x10, _AC_BITS, _AC_VALS)
              + _segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0])))
    return header + data.tobytes() + b"\xff\xd9", zz.astype(np.int16)


class MjpegAviWriter:
    """Mux raw JPEG frames into an MJPG ``.avi`` without transcoding.

    The operator records the sensor's MJPEG stream to ``.avi`` for offline
    processing; this writer wraps the received JPEG payloads verbatim in a
    minimal RIFF/AVI container (avih + one MJPG 'vids' stream + movi +
    idx1), so the stored bytes are bit-identical to what the camera sent.
    """

    def __init__(self, path: str, fps: float, size_wh: tuple[int, int]):
        self._f = open(path, "wb")
        self._fps = float(fps)
        self._w, self._h = size_wh
        self._sizes: list[int] = []
        w = self._f.write
        p = struct.pack
        w(b"RIFF" + p("<I", 0) + b"AVI ")                    # size patched
        # hdrl list: avih + strl(strh, strf)
        avih = p("<IIIIIIIIII4I",
                 int(1e6 / self._fps), 0, 0, 0x10,           # usec/frame, HASINDEX
                 0, 0, 1, 0, self._w, self._h, 0, 0, 0, 0)   # frames patched
        strh = (b"vids" + b"MJPG" + p("<IHHIIIIIIII", 0, 0, 0, 0,
                                      1000, int(self._fps * 1000),  # scale/rate
                                      0, 0, 0, 0xFFFFFFFF, 0)
                + p("<4H", 0, 0, self._w, self._h))
        strf = p("<IiiHH4sIiiII", 40, self._w, self._h, 1, 24, b"MJPG",
                 self._w * self._h * 3, 0, 0, 0, 0)
        strl = (b"LIST" + p("<I", 4 + 8 + len(strh) + 8 + len(strf))
                + b"strl" + b"strh" + p("<I", len(strh)) + strh
                + b"strf" + p("<I", len(strf)) + strf)
        hdrl = (b"LIST"
                + p("<I", 4 + 8 + len(avih) + len(strl))
                + b"hdrl" + b"avih" + p("<I", len(avih)) + avih + strl)
        self._avih_frames_pos = self._f.tell() + 8 + 4 + 8 + 16
        self._strh_length_pos = (self._f.tell() + 8 + 4 + 8 + len(avih)
                                 + 8 + 4 + 8 + 32)
        w(hdrl)
        self._movi_pos = self._f.tell()
        w(b"LIST" + p("<I", 0) + b"movi")                    # size patched

    def write_jpeg(self, data: bytes) -> None:
        w = self._f.write
        w(b"00dc" + struct.pack("<I", len(data)) + data)
        if len(data) & 1:
            w(b"\x00")
        self._sizes.append(len(data))

    def close(self) -> None:
        p = struct.pack
        f = self._f
        movi_end = f.tell()
        # idx1: one keyframe entry per chunk; offsets relative to 'movi'+4.
        f.write(b"idx1" + p("<I", 16 * len(self._sizes)))
        off = 4
        for sz in self._sizes:
            f.write(b"00dc" + p("<II", 0x10, off) + p("<I", sz))
            off += 8 + sz + (sz & 1)
        end = f.tell()
        n = len(self._sizes)
        f.seek(4)
        f.write(p("<I", end - 8))                            # RIFF size
        f.seek(self._avih_frames_pos)
        f.write(p("<I", n))                                  # dwTotalFrames
        f.seek(self._strh_length_pos)
        f.write(p("<I", n))                                  # strh dwLength
        f.seek(self._movi_pos + 4)
        f.write(p("<I", movi_end - self._movi_pos - 8))      # movi LIST size
        f.close()

    @property
    def frames_written(self) -> int:
        return len(self._sizes)
