"""JPEG decode on the card: entropy-decoded DCT coefficients -> gray frames.

Port of ``vision_basedsensor_tpu/ops/jpeg.py``. JPEG decoding splits at its
hardware boundary: the Huffman entropy decode is serial and branchy, so it
runs on the host in native C++ (``native/jpeg_coeffs.cpp``, a copy of the
reference's); dequantization, the 8x8 inverse DCT, level shift and block
reassembly are dense linear algebra and run batched on the device.

Four transports carry the coefficients from host to device (the reference
module's header has the full accounting):

* DENSE: the ``(B, bh, bw, 64)`` int16 coefficient tensor.
* PACKED: one (uint8 gap, int8 value) pair per nonzero in the batch's flat
  coefficient space, plus an int16 spill side stream for |v| > 127.
* SPLIT: DCs in a dense per-block nibble delta lane (spatial or temporal
  predictor per frame), ACs in a 1-or-2-byte VLC stream in zigzag order,
  with spill streams for the clamps; ``zmax`` < 64 band-limits it.
* TDELTA (the default): each block's temporal coefficient delta (frame 0
  absolute) in one VLC stream over the zmax-slot zigzag space; the device
  rebuilds frames with one cumsum over the frame axis.

The host half (``MjpegBatchDecoder.entropy_decode_*``, numpy + ctypes)
returns payloads array-for-array equal to the reference's. The device half
(``*_idct_frames``) takes torch tensors. Every scatter of a transport is
``ops/cuda/expand.py:expand_sorted``, the K8 kernel on a CUDA tensor and its
plain version on a CPU tensor; the VLC parity scan, the DC lane, the
temporal cumsum and the dequant-IDCT matmul are plain PyTorch, as they are
plain XLA in the reference.

Luma only: the perception pipeline is grayscale.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from vision_basedsensor_tpu_torch.core.device import CUDA, resolve
from vision_basedsensor_tpu_torch.io.mjpeg import sof_dims
from vision_basedsensor_tpu_torch.native import load_jpeg_lib
from vision_basedsensor_tpu_torch.ops.cuda.expand import expand_sorted


class HostPacked(NamedTuple):
    """Host-side result of the PACKED entropy decode — pure numpy, safe to
    produce on any thread; ``MjpegBatchDecoder.packed_to_device`` turns it
    into device frames."""
    gaps: np.ndarray
    vals: np.ndarray
    sgaps: np.ndarray
    sdeltas: np.ndarray
    qtables: np.ndarray
    height: int
    width: int
    grid: tuple[int, int]
    stats: dict


class HostDense(NamedTuple):
    """Host-side result of the DENSE entropy decode (see HostPacked)."""
    coeffs: np.ndarray
    qtables: np.ndarray
    height: int
    width: int
    stats: dict


class HostSplit(NamedTuple):
    """Host-side result of the SPLIT entropy decode (see HostPacked): the
    DC nibble lane, the AC VLC stream and their spill streams; ``zmax`` is
    the band limit the streams were encoded with."""
    ac: np.ndarray
    dc: np.ndarray
    sgaps: np.ndarray
    sdeltas: np.ndarray
    dgaps: np.ndarray
    ddeltas: np.ndarray
    qtables: np.ndarray
    height: int
    width: int
    grid: tuple[int, int]
    stats: dict
    zmax: int = 64


class HostTDelta(NamedTuple):
    """Host-side result of the TDELTA entropy decode (see HostPacked): ONE
    VLC byte stream of temporal coefficient deltas (slot 0 = DC) + its
    spill side stream; ``zmax`` is the band limit."""
    ac: np.ndarray
    sgaps: np.ndarray
    sdeltas: np.ndarray
    qtables: np.ndarray
    height: int
    width: int
    grid: tuple[int, int]
    stats: dict
    zmax: int = 64

# Growable-capacity return codes from native/jpeg_coeffs.cpp. Any OTHER
# nonzero code is a hard parse failure — retrying with bigger buffers would
# just re-parse a malformed JPEG with progressively larger allocations.
_RC_BLOCK_CAP = -11
_RC_VAL_CAP = -100
_RC_SPILL_CAP = -102
_RC_AC_CAP = -104
_RC_AC_SPILL_CAP = -105
_RC_DC_SPILL_CAP = -106


def _idct8_basis() -> np.ndarray:
    """A[i, k] = alpha(k) cos((2i+1) k pi / 16): pixels = A @ C @ A^T."""
    k = np.arange(8)
    i = np.arange(8)[:, None]
    A = np.cos((2 * i + 1) * k * np.pi / 16.0)
    A *= np.where(k == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    return A.astype(np.float32)


# Natural index of each zigzag scan position (T.81 figure A.6) — must match
# native/jpeg_coeffs.cpp:kZigzag.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)


@functools.cache
def _idct64_basis(zigzag: bool = False) -> np.ndarray:
    """Flat 2D-IDCT map: ``M[(k,l), (i,j)] = A[i,k] A[j,l]``, so
    ``pixels_flat = coeffs_flat @ M`` in one (N, 64) @ (64, 64) matmul.
    ``zigzag`` row-permutes M so zigzag-ordered coefficient vectors
    multiply directly."""
    A = _idct8_basis()
    M = np.einsum("ik,jl->klij", A, A).reshape(64, 64).astype(np.float32)
    return M[_ZIGZAG] if zigzag else M


def _dequant_idct(coeffs: torch.Tensor, qtable: torch.Tensor, height: int,
                  width: int, zigzag: bool = False) -> torch.Tensor:
    """``(B, bh, bw, Z)`` float coefficients -> ``(B, height, width)`` gray.

    One ``(B, bh*bw, Z) @ (Z, 64)`` float32 matmul (full float32: the
    package turns TF32 off). ``zigzag`` says how ``coeffs``' last axis is
    ordered; the contraction ALWAYS runs in zigzag order (natural-order
    inputs are permuted first), because the summation order is part of the
    transports' bitwise-identical-output contract. With ``zigzag`` the last
    axis may be a zigzag prefix of length Z < 64 (the band limit), which
    uses the first Z rows of the basis."""
    dev = coeffs.device
    zz = torch.as_tensor(_ZIGZAG, device=dev).long()
    if not zigzag:
        coeffs = coeffs[..., zz]
    z = coeffs.shape[-1]
    M = torch.as_tensor(_idct64_basis(True)[:z], device=dev)
    b, bh, bw, _ = coeffs.shape
    q = qtable.to(torch.float32)[..., zz[:z]]   # tables stored natural-order
    if q.ndim == 2:
        q = q[:, None, None, :]
    px = torch.matmul((coeffs * q).reshape(b, bh * bw, z), M) + 128.0
    img = (px.reshape(b, bh, bw, 8, 8).permute(0, 1, 3, 2, 4)
           .reshape(b, bh * 8, bw * 8))
    img = torch.clamp(torch.floor(img + 0.5), 0.0, 255.0)
    return img[:, :height, :width]


def idct_frames(coeffs: torch.Tensor, qtable: torch.Tensor, *, height: int,
                width: int) -> torch.Tensor:
    """Quantized luma coefficients ``(B, bh, bw, 64)`` int16 (natural order)
    and ``(B, 64)`` or ``(64,)`` quantization tables (natural order) ->
    float32 frames ``(B, height, width)`` in 0..255."""
    return _dequant_idct(coeffs.to(torch.float32), qtable, height, width)


def gap_positions(gaps: torch.Tensor) -> torch.Tensor:
    """Implied positions of a (uint8 or uint16) gap stream: an int32 cumsum
    minus one, as the reference's int32 positions (torch would widen an
    integer cumsum to int64 by default)."""
    return torch.cumsum(gaps, 0, dtype=torch.int32) - 1


def delta_idct_frames(gaps: torch.Tensor, vals: torch.Tensor,
                      sgaps: torch.Tensor, sdeltas: torch.Tensor,
                      qtable: torch.Tensor, *, height: int, width: int,
                      grid: tuple[int, int]) -> torch.Tensor:
    """PACKED streams -> gray frames (the reference's
    ``delta_idct_frames``).

    ``gaps`` uint8 strictly-positive position deltas (first relative to -1;
    tail pads (255, 0) overrun and drop), ``vals`` int8; ``sgaps``/``sdeltas``
    the uint8/int16 spill stream, tail pads (0, 0). Identical to
    :func:`idct_frames` on the equivalent dense tensor."""
    bh, bw = grid
    b = qtable.shape[0]
    flat = expand_sorted(gap_positions(gaps), vals.to(torch.int16),
                         b * bh * bw * 64, gap_positions(sgaps), sdeltas)
    return _dequant_idct(flat.reshape(b, bh, bw, 64).to(torch.float32),
                         qtable, height, width)


def _vlc_entries(ac: torch.Tensor, carries: torch.Tensor):
    """Entry starts of a 1-or-2-byte VLC stream by run parity: byte i starts
    an entry iff (i - m[i-1]) is odd, where m[i] = last index <= i whose
    byte does not mark a payload byte (``carries`` False). Returns
    ``(start, nxt)``: the start mask and each byte's successor (the payload
    of a two-byte entry)."""
    idx = torch.arange(ac.shape[0], dtype=torch.int32, device=ac.device)
    m = torch.cummax(torch.where(carries, torch.full_like(idx, -1), idx),
                     0).values
    m_prev = torch.cat([torch.full((1,), -1, dtype=torch.int32,
                                   device=ac.device), m[:-1]])
    start = ((idx - m_prev) & 1) == 1
    nxt = torch.cat([ac[1:], ac[-1:]])
    return start, nxt


def split_idct_frames(ac: torch.Tensor, dc: torch.Tensor, sgaps: torch.Tensor,
                      sdeltas: torch.Tensor, dgaps: torch.Tensor,
                      ddeltas: torch.Tensor, qtable: torch.Tensor, *,
                      height: int, width: int, grid: tuple[int, int],
                      zmax: int = 64) -> torch.Tensor:
    """SPLIT streams -> gray frames (the reference's ``split_idct_frames``,
    whose docstring defines the byte formats).

    ``ac`` uint8 VLC stream over the (zmax-1)-slot zigzag AC space; ``dc``
    uint8 DC nibble lane (per frame a predictor flag nibble, then one
    clamped delta nibble per block); ``sgaps``/``sdeltas`` and
    ``dgaps``/``ddeltas`` the uint16/int16 AC and DC spill streams, tail
    pads (0, 0). zmax=64 is bitwise identical to :func:`idct_frames`; lower
    values equal the dense decode with zigzag indices >= zmax zeroed."""
    bh, bw = grid
    b = qtable.shape[0]
    blocks = bh * bw
    ns = zmax - 1
    low = (ac & 7).to(torch.int32)
    v5 = ((ac >> 3).to(torch.int32) ^ 16) - 16   # sign-extend 5 bits
    ext = v5 == -15
    start, nxt = _vlc_entries(ac, ext)
    esc = (v5 == -16) & start
    is_ext = ext & start
    # uint8 -> int8 is the reference's bit reinterpretation (astype), not a
    # value conversion: view.
    val = torch.where(is_ext, nxt.view(torch.int8).to(torch.int32),
                      torch.where(esc, 0, v5))
    val = torch.where(start, val, 0).to(torch.int16)
    step = torch.where(start, torch.where(esc, (low + 1) * ns, low + 1), 0)
    # ADD, not SET: ext value bytes carry step 0 / value 0 and repeat their
    # starter's position.
    flat = expand_sorted(gap_positions(step), val, b * blocks * ns,
                         gap_positions(sgaps), sdeltas)
    # DC nibble lane -> per-frame flag + clamped deltas, then the spills.
    bpf2 = (blocks + 2) // 2   # ceil((blocks + 1) / 2): flag + blocks
    dcb = dc.reshape(b, bpf2)
    nib = torch.stack([dcb & 15, dcb >> 4], dim=-1).reshape(b, 2 * bpf2)
    spatial = (nib[:, 0] & 1) == 0
    spatial[0] = True   # frame 0 has no temporal predictor
    d = ((nib[:, 1:blocks + 1].to(torch.int32) ^ 8) - 8).reshape(b * blocks)
    d = d + expand_sorted(gap_positions(dgaps), ddeltas, b * blocks).to(
        torch.int32)
    # Flag-segmented reconstruction: spatial frames are self-contained
    # (cumsum over blocks); temporal frames stack their deltas on the last
    # spatial frame via a frame-axis prefix sum rebased per segment.
    d = d.reshape(b, blocks)
    lead = torch.cumsum(d, -1, dtype=torch.int32)
    base = torch.where(spatial[:, None], lead, d)
    csum = torch.cumsum(base, 0, dtype=torch.int32)
    seg = torch.cummax(torch.where(spatial, torch.arange(
        b, dtype=torch.int32, device=dc.device), 0), 0).values.long()
    dcv = (csum - csum[seg] + base[seg]).to(torch.int16)
    # [dc | zz1..zz(zmax-1)] IS the zigzag-ordered coefficient prefix.
    coeffs = torch.cat([dcv.reshape(b * blocks, 1),
                        flat.reshape(b * blocks, ns)], dim=1)
    return _dequant_idct(coeffs.reshape(b, bh, bw, zmax).to(torch.float32),
                         qtable, height, width, zigzag=True)


def tdelta_idct_frames(ac: torch.Tensor, sgaps: torch.Tensor,
                       sdeltas: torch.Tensor, qtable: torch.Tensor, *,
                       height: int, width: int, grid: tuple[int, int],
                       zmax: int = 64) -> torch.Tensor:
    """TDELTA stream -> gray frames (the reference's ``tdelta_idct_frames``,
    whose docstring defines the byte format).

    ``ac`` uint8 VLC stream of temporal deltas in the zmax-slot zigzag
    space (slot 0 = DC); an EXT byte or a two-byte escape marks the next
    byte as payload; tail pads 0x86 overrun and drop. ``sgaps``/``sdeltas``
    the uint16/int16 spill stream, tail pads (0, 0). The deltas telescope:
    a cumsum over the frame axis gives each frame's quantized coefficients,
    which dequantize with that frame's own table."""
    bh, bw = grid
    b = qtable.shape[0]
    blocks = bh * bw
    pos, val = tdelta_entries(ac, zmax)
    flat = expand_sorted(pos, val, b * blocks * zmax, gap_positions(sgaps),
                         sdeltas)
    # Telescoping temporal reconstruction, kept in int32 like the reference.
    coeffs = torch.cumsum(flat.reshape(b, blocks * zmax), 0,
                          dtype=torch.int32)
    return _dequant_idct(coeffs.reshape(b, bh, bw, zmax).to(torch.float32),
                         qtable, height, width, zigzag=True)


def tdelta_entries(ac: torch.Tensor, zmax: int = 64):
    """The TDELTA stream's sorted (int32 position, int16 value) entries in
    the zmax-slot space: a start byte's delta at its position, payload
    bytes with value 0 at their starter's position, escapes with value 0
    at the position they skip to."""
    ns = zmax
    low = (ac & 7).to(torch.int32)
    v5 = ((ac >> 3).to(torch.int32) ^ 16) - 16   # sign-extend 5 bits
    carries = (v5 == -15) | ((v5 == -16) & (low == 7))
    start, nxt = _vlc_entries(ac, carries)
    esc = (v5 == -16) & start
    esc2 = esc & (low == 7)
    is_ext = (v5 == -15) & start
    # uint8 -> int8 reinterprets the bits (the reference's astype): view.
    val = torch.where(is_ext, nxt.view(torch.int8).to(torch.int32),
                      torch.where(esc, 0, v5))
    val = torch.where(start, val, 0).to(torch.int16)
    skip = torch.where(esc2, (8 + nxt.to(torch.int32)) * ns, (low + 1) * ns)
    step = torch.where(start, torch.where(esc, skip, low + 1), 0)
    return gap_positions(step), val


def _bucket(n: int, minimum: int = 1 << 12) -> int:
    """Smallest 9/8-ratio geometric bucket >= n: the reference pads device
    streams to few distinct lengths (one jit compile each) at <= 12.5%
    padding; kept so the payloads equal the reference's byte for byte."""
    b = minimum
    while b < n:
        b += max(minimum, b >> 3)
    return b


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class MjpegBatchDecoder:
    """Batch JPEG -> device gray frames via the native entropy decoder.

    Port of the reference's ``MjpegBatchDecoder``. Stateless w.r.t. the
    stream apart from the geometry learned from the first frame. The host
    half (``entropy_decode_*``) is numpy + ctypes and safe on a prefetch
    thread; the device half (``*_to_device``) copies a payload to
    ``device`` (the card by default) and decodes it there. Construction
    raises when the native library cannot be built.
    """

    def __init__(self, workers: int | None = None, device=CUDA):
        """``workers``: host threads for the entropy decode (frames are
        independent). Default = cpu count; 1 = the serial path. The output
        is semantically identical either way."""
        self.device = resolve(device)
        self._lib = load_jpeg_lib()
        self._workers = (os.cpu_count() or 1) if workers is None else workers
        self._meta: tuple | None = None  # (w, h, bw, bh)
        self._qtable: np.ndarray | None = None
        self._cap = 0
        self._scap = 0
        # Persistent output buffers, grown on demand; payloads are copies.
        self._gaps: np.ndarray | None = None
        self._vals: np.ndarray | None = None
        self._sgaps: np.ndarray | None = None
        self._sdeltas: np.ndarray | None = None
        self._accap = 0
        self._ascap = 0
        self._dscap = 0
        self._ac: np.ndarray | None = None
        self._dc: np.ndarray | None = None
        self._asg: np.ndarray | None = None
        self._asd: np.ndarray | None = None
        self._dsg: np.ndarray | None = None
        self._dsd: np.ndarray | None = None
        self._tcap = 0
        self._tscap = 0
        self._tac: np.ndarray | None = None
        self._tsg: np.ndarray | None = None
        self._tsd: np.ndarray | None = None
        self.last_stats: dict | None = None

    def _ensure_meta(self, first_jpeg: bytes) -> None:
        """Learn (or re-learn) the stream geometry from the batch's first
        frame. The SOF sniff catches pixel-dimension changes; block-grid
        changes at the same pixel dims are caught after the batch call by
        comparing the returned meta (``_relearn_or_raise``)."""
        if self._meta is None:
            self._probe(first_jpeg)
            return
        dims = sof_dims(first_jpeg)
        if dims is not None and dims != (self._meta[0], self._meta[1]):
            self._probe(first_jpeg)
            self._cap = self._scap = 0
            self._accap = self._ascap = self._dscap = 0

    def _relearn_or_raise(self, jpegs: list[bytes], got: int, n: int) -> None:
        """After a batch call that failed or returned a different geometry:
        re-probe frame 0 to tell a block-grid change at the same pixel dims
        (retry with fresh meta) from a malformed frame (raise)."""
        old = self._meta
        self._probe(jpegs[0])           # raises if frame 0 is malformed
        if self._meta == old and got != n:
            raise ValueError(f"JPEG batch decode failed at frame {got}")
        self._cap = self._scap = 0
        self._accap = self._ascap = self._dscap = 0

    def _probe(self, jpeg: bytes) -> None:
        meta = (ctypes.c_int32 * 4)()
        q = (ctypes.c_uint16 * 64)()
        # Start with 1080p block capacity and grow on the capacity code.
        cap = (1920 // 8) * (1088 // 8)
        while True:
            buf = np.empty((cap, 64), np.int16)
            rc = self._lib.vbs_jpeg_y_coeffs(jpeg, len(jpeg),
                                             _ptr(buf, ctypes.c_int16), cap,
                                             meta, q)
            if rc == 0:
                break
            if rc != _RC_BLOCK_CAP or cap >= (8192 // 8) ** 2:
                raise ValueError(f"JPEG parse failed (rc={rc})")
            cap *= 4
        self._meta = (meta[0], meta[1], meta[2], meta[3])
        self._qtable = np.array(q[:], np.uint16)

    def _batch_args(self, jpegs: list[bytes]):
        data = b"".join(jpegs)
        sizes = np.array([len(j) for j in jpegs], np.int32)
        offsets = np.zeros(len(jpegs), np.int64)
        offsets[1:] = np.cumsum(sizes[:-1], dtype=np.int64)
        # data_as pointers keep their arrays alive.
        return (data, _ptr(offsets, ctypes.c_int64),
                _ptr(sizes, ctypes.c_int32), len(jpegs))

    def _to(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- DENSE ---------------------------------------------------------------

    def dense_to_device(self, hd: HostDense) -> torch.Tensor:
        """Device half of the DENSE transport."""
        self.last_stats = hd.stats
        return idct_frames(self._to(hd.coeffs), self._to(hd.qtables),
                           height=hd.height, width=hd.width)

    def entropy_decode_dense(self, jpegs: list[bytes]) -> HostDense:
        """Host half of the DENSE transport."""
        self._ensure_meta(jpegs[0])
        args = self._batch_args(jpegs)
        n = args[-1]
        for attempt in range(2):
            w, h, bw, bh = self._meta
            blocks = bw * bh
            coeffs = np.empty((n, bh, bw, 64), np.int16)
            meta = (ctypes.c_int32 * 4)()
            qtables = np.empty((n, 64), np.uint16)
            got = self._lib.vbs_mjpeg_batch_y_coeffs(
                *args, _ptr(coeffs, ctypes.c_int16), blocks, meta,
                _ptr(qtables, ctypes.c_uint16))
            if got == n and tuple(meta) == self._meta:
                break
            if attempt > 0:
                raise ValueError(f"JPEG batch decode failed at frame {got}")
            # A block-grid change at the same pixel dims (chroma subsampling
            # switch) fails the call or returns another meta: re-learn the
            # geometry and retry once.
            self._relearn_or_raise(jpegs, got, n)
        stats = {"transport": "dense", "frames": n,
                 "bytes_shipped": coeffs.nbytes + qtables.nbytes}
        self.last_stats = stats
        return HostDense(coeffs, qtables, h, w, stats)

    # -- PACKED --------------------------------------------------------------

    def packed_to_device(self, hp: HostPacked) -> torch.Tensor:
        """Device half of the PACKED transport."""
        self.last_stats = hp.stats
        return delta_idct_frames(
            self._to(hp.gaps), self._to(hp.vals), self._to(hp.sgaps),
            self._to(hp.sdeltas), self._to(hp.qtables), height=hp.height,
            width=hp.width, grid=hp.grid)

    def entropy_decode_packed(self, jpegs: list[bytes]) -> HostPacked:
        """Host half of the PACKED transport."""
        self._ensure_meta(jpegs[0])
        n = len(jpegs)
        args = None
        for attempt in range(2):
            w, h, bw, bh = self._meta
            blocks = bw * bh
            # The device positions are an int32 cumsum over the batch's
            # flat coefficient space: past 2^31 they would wrap. Checked
            # before the payload join below.
            if n * blocks * 64 >= 2 ** 31:
                raise ValueError(
                    f"packed transport: batch of {n} frames x {blocks} "
                    f"blocks exceeds the int32 position space "
                    f"({n * blocks * 64} >= 2^31); split the batch")
            if args is None:
                args = self._batch_args(jpegs)
            if self._cap == 0:
                # Typical sparsity (~5 entries per block incl. fillers);
                # grow on the capacity codes.
                self._cap = 5 * blocks * n
                self._scap = max(blocks * n // 16, 1 << 12)
            meta = (ctypes.c_int32 * 4)()
            qtables = np.empty((n, 64), np.uint16)
            counts = np.zeros(2, np.int64)
            while True:
                if self._gaps is None or self._gaps.size < self._cap:
                    self._gaps = np.empty(self._cap, np.uint8)
                    self._vals = np.empty(self._cap, np.int8)
                if self._sgaps is None or self._sgaps.size < self._scap:
                    self._sgaps = np.empty(self._scap, np.uint8)
                    self._sdeltas = np.empty(self._scap, np.int16)
                call_args = (
                    *args, _ptr(self._gaps, ctypes.c_uint8),
                    _ptr(self._vals, ctypes.c_int8), self._cap,
                    _ptr(self._sgaps, ctypes.c_uint8),
                    _ptr(self._sdeltas, ctypes.c_int16), self._scap,
                    _ptr(counts, ctypes.c_int64), blocks, meta,
                    _ptr(qtables, ctypes.c_uint16))
                if self._workers > 1:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_delta_mt(
                        *call_args, self._workers)
                else:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_delta(*call_args)
                if got == n:
                    break
                if got == _RC_VAL_CAP:
                    self._cap = min(2 * self._cap, 66 * blocks * n)
                elif got == _RC_SPILL_CAP:
                    self._scap = min(2 * self._scap, 66 * blocks * n)
                else:
                    break
            if got == n and tuple(meta) == self._meta:
                break
            if attempt > 0:
                raise ValueError(f"JPEG batch decode failed at frame {got}")
            self._relearn_or_raise(jpegs, got, n)
        e_n, s_n = int(counts[0]), int(counts[1])
        e_b = min(_bucket(e_n), self._gaps.size)
        s_b = min(_bucket(s_n), self._sgaps.size)
        # The (255, 0) tail fillers climb past the tensor end; they must
        # stay inside int32 or they wrap back into the valid range.
        if n * blocks * 64 + 255 * (e_b - e_n) >= 2 ** 31:
            raise ValueError(
                "packed transport: tail-filler positions would exceed the "
                "int32 position space; split the batch")
        # Copies (the next batch reuses the persistent buffers) with
        # deterministic tail padding: (255, 0) fillers overrun and drop;
        # (0, 0) spill pads add zero wherever they land.
        gaps = self._gaps[:e_b].copy()
        vals = self._vals[:e_b].copy()
        gaps[e_n:] = 255
        vals[e_n:] = 0
        sgaps = self._sgaps[:s_b].copy()
        sdeltas = self._sdeltas[:s_b].copy()
        sgaps[s_n:] = 0
        sdeltas[s_n:] = 0
        stats = {
            "transport": "packed", "frames": n, "nnz": e_n,
            "bytes_shipped": 2 * e_b + 3 * s_b + qtables.nbytes,
            "bytes_dense": n * blocks * 128 + qtables.nbytes,
        }
        self.last_stats = stats
        return HostPacked(gaps, vals, sgaps, sdeltas, qtables, h, w,
                          (bh, bw), stats)

    # -- SPLIT ---------------------------------------------------------------

    def split_to_device(self, hs: HostSplit) -> torch.Tensor:
        """Device half of the SPLIT transport."""
        self.last_stats = hs.stats
        return split_idct_frames(
            self._to(hs.ac), self._to(hs.dc), self._to(hs.sgaps),
            self._to(hs.sdeltas), self._to(hs.dgaps), self._to(hs.ddeltas),
            self._to(hs.qtables), height=hs.height, width=hs.width,
            grid=hs.grid, zmax=hs.zmax)

    def entropy_decode_split(self, jpegs: list[bytes],
                             zmax: int = 64) -> HostSplit:
        """Host half of the SPLIT transport (``zmax`` in [2, 64])."""
        if not 2 <= zmax <= 64:
            raise ValueError(f"zmax must be in [2, 64], got {zmax}")
        ns = zmax - 1
        self._ensure_meta(jpegs[0])
        n = len(jpegs)
        args = None
        for attempt in range(2):
            w, h, bw, bh = self._meta
            blocks = bw * bh
            if n * blocks * ns >= 2 ** 31:
                raise ValueError(
                    f"split transport: batch of {n} frames x {blocks} "
                    f"blocks exceeds the int32 position space; split the "
                    f"batch")
            if args is None:
                args = self._batch_args(jpegs)
            if self._accap == 0:
                self._accap = 5 * blocks * n
                self._ascap = max(blocks * n // 16, 1 << 12)
                self._dscap = max(blocks * n // 64, 1 << 12)
            meta = (ctypes.c_int32 * 4)()
            qtables = np.empty((n, 64), np.uint16)
            counts = np.zeros(3, np.int64)
            bpf2 = (blocks + 2) // 2   # nibble lane: flag + blocks nibbles
            if self._dc is None or self._dc.size < n * bpf2:
                self._dc = np.empty(n * bpf2, np.uint8)
            while True:
                if self._ac is None or self._ac.size < self._accap:
                    self._ac = np.empty(self._accap, np.uint8)
                if self._asg is None or self._asg.size < self._ascap:
                    self._asg = np.empty(self._ascap, np.uint16)
                    self._asd = np.empty(self._ascap, np.int16)
                if self._dsg is None or self._dsg.size < self._dscap:
                    self._dsg = np.empty(self._dscap, np.uint16)
                    self._dsd = np.empty(self._dscap, np.int16)
                call_args = (
                    *args, _ptr(self._ac, ctypes.c_uint8), self._accap,
                    _ptr(self._dc, ctypes.c_uint8),
                    _ptr(self._asg, ctypes.c_uint16),
                    _ptr(self._asd, ctypes.c_int16), self._ascap,
                    _ptr(self._dsg, ctypes.c_uint16),
                    _ptr(self._dsd, ctypes.c_int16), self._dscap,
                    _ptr(counts, ctypes.c_int64), blocks, meta,
                    _ptr(qtables, ctypes.c_uint16), zmax)
                if self._workers > 1:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_split_mt(
                        *call_args, self._workers)
                else:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_split(*call_args)
                if got == n:
                    break
                if got == _RC_AC_CAP:
                    self._accap = min(2 * self._accap, 140 * blocks * n)
                elif got == _RC_AC_SPILL_CAP:
                    self._ascap = min(2 * self._ascap, 64 * blocks * n)
                elif got == _RC_DC_SPILL_CAP:
                    self._dscap = min(2 * self._dscap, 2 * blocks * n)
                else:
                    break
            if got == n and tuple(meta) == self._meta:
                break
            if attempt > 0:
                raise ValueError(f"JPEG batch decode failed at frame {got}")
            self._relearn_or_raise(jpegs, got, n)
        a_n, s_n, d_n = int(counts[0]), int(counts[1]), int(counts[2])
        a_b = min(_bucket(a_n), self._ac.size)
        s_b = min(_bucket(s_n), self._asg.size)
        d_b = min(_bucket(d_n), self._dsg.size)
        # Tail-pad overrun guard: AC pads are 0x87 escapes, 8 blocks each.
        if n * blocks * ns + 8 * ns * (a_b - a_n) >= 2 ** 31:
            raise ValueError(
                "split transport: tail-pad positions would exceed the "
                "int32 position space; split the batch")
        ac = self._ac[:a_b].copy()
        ac[a_n:] = 0x87   # escape x 8 blocks: positions overrun and drop
        dc = self._dc[:n * ((blocks + 2) // 2)].copy()
        sgaps = self._asg[:s_b].copy()
        sdeltas = self._asd[:s_b].copy()
        sgaps[s_n:] = 0
        sdeltas[s_n:] = 0
        dgaps = self._dsg[:d_b].copy()
        ddeltas = self._dsd[:d_b].copy()
        dgaps[d_n:] = 0
        ddeltas[d_n:] = 0
        stats = {
            "transport": "split", "frames": n, "nnz": a_n, "zmax": zmax,
            "bytes_shipped": (a_b + n * ((blocks + 2) // 2) + 4 * s_b
                              + 4 * d_b + qtables.nbytes),
            "bytes_dense": n * blocks * 128 + qtables.nbytes,
        }
        self.last_stats = stats
        return HostSplit(ac, dc, sgaps, sdeltas, dgaps, ddeltas, qtables,
                         h, w, (bh, bw), stats, zmax)

    # -- TDELTA --------------------------------------------------------------

    def tdelta_to_device(self, ht: HostTDelta) -> torch.Tensor:
        """Device half of the TDELTA transport."""
        self.last_stats = ht.stats
        return tdelta_idct_frames(
            self._to(ht.ac), self._to(ht.sgaps), self._to(ht.sdeltas),
            self._to(ht.qtables), height=ht.height, width=ht.width,
            grid=ht.grid, zmax=ht.zmax)

    def entropy_decode_tdelta(self, jpegs: list[bytes],
                              zmax: int = 64) -> HostTDelta:
        """Host half of the TDELTA transport (``zmax`` in [2, 64]). Every
        batch is self-contained: its first frame deltas against zeros."""
        if not 2 <= zmax <= 64:
            raise ValueError(f"zmax must be in [2, 64], got {zmax}")
        ns = zmax
        self._ensure_meta(jpegs[0])
        n = len(jpegs)
        args = None
        for attempt in range(2):
            w, h, bw, bh = self._meta
            blocks = bw * bh
            if n * blocks * ns >= 2 ** 31:
                raise ValueError(
                    f"tdelta transport: batch of {n} frames x {blocks} "
                    f"blocks exceeds the int32 position space; split the "
                    f"batch")
            if args is None:
                args = self._batch_args(jpegs)
            if self._tcap == 0:
                # The first frame ships absolute (~1 byte/nonzero); size
                # for that and grow on demand.
                self._tcap = max(2 * blocks * n, 1 << 16)
                self._tscap = max(blocks * n // 64, 1 << 12)
            meta = (ctypes.c_int32 * 4)()
            qtables = np.empty((n, 64), np.uint16)
            counts = np.zeros(2, np.int64)
            while True:
                if self._tac is None or self._tac.size < self._tcap:
                    self._tac = np.empty(self._tcap, np.uint8)
                if self._tsg is None or self._tsg.size < self._tscap:
                    self._tsg = np.empty(self._tscap, np.uint16)
                    self._tsd = np.empty(self._tscap, np.int16)
                call_args = (
                    *args, _ptr(self._tac, ctypes.c_uint8), self._tcap,
                    _ptr(self._tsg, ctypes.c_uint16),
                    _ptr(self._tsd, ctypes.c_int16), self._tscap,
                    _ptr(counts, ctypes.c_int64), blocks, meta,
                    _ptr(qtables, ctypes.c_uint16), zmax)
                if self._workers > 1:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_tdelta_mt(
                        *call_args, self._workers)
                else:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_tdelta(
                        *call_args)
                if got == n:
                    break
                if got == _RC_AC_CAP:
                    # Ceiling: nnz(cur) + nnz(prev) entries of <= 2 bytes.
                    self._tcap = min(2 * self._tcap, 280 * blocks * n)
                elif got == _RC_AC_SPILL_CAP:
                    self._tscap = min(2 * self._tscap, 128 * blocks * n)
                else:
                    break
            if got == n and tuple(meta) == self._meta:
                break
            if attempt > 0:
                raise ValueError(f"JPEG batch decode failed at frame {got}")
            self._relearn_or_raise(jpegs, got, n)
        a_n, s_n = int(counts[0]), int(counts[1])
        a_b = min(_bucket(a_n), self._tac.size)
        s_b = min(_bucket(s_n), self._tsg.size)
        # Tail-pad overrun guard: pads are 0x86 escapes, 7 blocks each.
        if n * blocks * ns + 7 * ns * (a_b - a_n) >= 2 ** 31:
            raise ValueError(
                "tdelta transport: tail-pad positions would exceed the "
                "int32 position space; split the batch")
        ac = self._tac[:a_b].copy()
        ac[a_n:] = 0x86   # escape, 7 blocks: positions overrun and drop
        sgaps = self._tsg[:s_b].copy()
        sdeltas = self._tsd[:s_b].copy()
        sgaps[s_n:] = 0
        sdeltas[s_n:] = 0
        stats = {
            "transport": "tdelta", "frames": n, "nnz": a_n, "zmax": zmax,
            "bytes_shipped": a_b + 4 * s_b + qtables.nbytes,
            "bytes_dense": n * blocks * 128 + qtables.nbytes,
        }
        self.last_stats = stats
        return HostTDelta(ac, sgaps, sdeltas, qtables, h, w, (bh, bw),
                          stats, zmax)
