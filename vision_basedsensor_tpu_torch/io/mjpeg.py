"""MJPEG-over-HTTP client: the sensor's live stream as a pipeline source.

Port of ``vision_basedsensor_tpu/io/mjpeg.py``. The acquisition server
streams ``multipart/x-mixed-replace`` JPEGs; ``iter_mjpeg_bytes`` parses the
parts (``cli record`` muxes them into an ``.avi`` verbatim), a
``_StreamReader`` thread drains the socket into a bounded drop-oldest queue,
and two sources feed ``StreamingPipeline.run``: ``MjpegVideoSource`` decodes
on the host (cv2, else PIL, imported when a frame is decoded) and
``MjpegCudaVideoSource`` (the twin of ``MjpegTpuVideoSource``) does only the
native entropy decode on the host and the rest on the card
(``ops/jpeg.py:MjpegBatchDecoder``), in the split form that
``io/video.py:device_feed`` drives. ``MjpegVideoSource`` without cv2 decodes
a gray JPEG to three equal channels, where the JAX package's PIL fallback
mirrors it.
"""
from __future__ import annotations

import collections
import threading
import time
import urllib.request
from typing import Iterator

import numpy as np

from vision_basedsensor_tpu_torch.core.device import CUDA
from vision_basedsensor_tpu_torch.io.video import decode_jpeg
from vision_basedsensor_tpu_torch.utils.log import get_logger

_log = get_logger(__name__)


def sof_dims(jpeg: bytes) -> tuple[int, int] | None:
    """(width, height) from a JPEG's SOF header — a pure-Python marker scan,
    shared by the batch decoder's per-batch geometry sniff (``ops/jpeg.py``)
    and ``cli record``'s AVI header. Handles APPn/DRI segments via the
    generic length skip and 0xFF fill bytes before markers."""
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


def iter_mjpeg_bytes(url: str, max_frames: int | None = None
                     ) -> Iterator[bytes]:
    """Yield raw JPEG payloads from an MJPEG stream URL (no decode).

    The boundary comes from the Content-Type header (``frame`` where it
    names none; a parameter that nonconformingly carries the leading dashes
    is normalized), each part's headers are read, and the payload length
    comes from Content-Length when the server sends one: scanning for JPEG
    SOI/EOI magic would truncate frames whose EXIF thumbnail embeds an
    inner EOI. Without Content-Length the payload runs to the next boundary.
    A read that waits 10 s raises.
    """
    with urllib.request.urlopen(url, timeout=10.0) as resp:
        ctype = resp.headers.get("Content-Type", "")
        b = "frame"
        for piece in ctype.split(";"):
            piece = piece.strip()
            if piece.startswith("boundary="):
                b = piece[len("boundary="):].strip('"')
        # RFC 2046: the delimiter is "--" + the boundary parameter.
        boundary = b"--" + b.lstrip("-").encode()

        buf = b""
        count = 0
        while max_frames is None or count < max_frames:
            chunk = resp.read(65536)
            if not chunk:
                break
            buf += chunk
            while True:
                start = buf.find(boundary)
                if start == -1:
                    break
                hdr_end = buf.find(b"\r\n\r\n", start)
                if hdr_end == -1:
                    break
                headers = buf[start + len(boundary):hdr_end]
                length = None
                for line in headers.split(b"\r\n"):
                    k, _, v = line.partition(b":")
                    if k.strip().lower() == b"content-length":
                        try:
                            length = int(v.strip())
                        except ValueError:
                            length = None
                payload_start = hdr_end + 4
                if length is not None:
                    if len(buf) < payload_start + length:
                        break  # need more bytes
                    frame_bytes = buf[payload_start:payload_start + length]
                    buf = buf[payload_start + length:]
                else:
                    nxt = buf.find(boundary, payload_start)
                    if nxt == -1:
                        break
                    frame_bytes = buf[payload_start:nxt].rstrip(b"\r\n")
                    buf = buf[nxt:]
                if not frame_bytes:
                    continue
                count += 1
                yield frame_bytes
                if max_frames is not None and count >= max_frames:
                    return


def iter_mjpeg(url: str, max_frames: int | None = None
               ) -> Iterator[np.ndarray]:
    """Yield decoded BGR frames from an MJPEG stream URL (see
    :func:`iter_mjpeg_bytes` for the parsing contract)."""
    for frame_bytes in iter_mjpeg_bytes(url, max_frames):
        yield decode_jpeg(frame_bytes)


class _StreamReader:
    """Background socket reader for live MJPEG sources.

    The consumer never drives the socket: while it is busy (the first
    chunk builds the CUDA kernels), an unread socket would stall the
    server's writer and the read would time out. The reader thread drains
    the socket at stream rate into a bounded drop-oldest deque, so a slow
    consumer sees the latest frames, never a growing stale backlog
    (``dropped`` counts what it skipped). Transient gaps reconnect with
    backoff, but only once the stream has produced; an error of the reader
    is raised in the consumer by :meth:`frames`.
    """

    def __init__(self, url: str, max_frames: int | None, maxlen: int,
                 reconnects: int = 3):
        self._dq: collections.deque = collections.deque(maxlen=maxlen)
        self._cond = threading.Condition()
        self._done = False
        self._err: Exception | None = None
        self.dropped = 0
        self.reconnects = 0
        self._thread = threading.Thread(
            target=self._run, args=(url, max_frames, reconnects),
            daemon=True)
        self._thread.start()

    def _push(self, jb: bytes) -> None:
        with self._cond:
            if len(self._dq) == self._dq.maxlen:
                self.dropped += 1
            self._dq.append(jb)
            self._cond.notify()

    def _run(self, url: str, max_frames: int | None,
             reconnects: int) -> None:
        count = 0
        try:
            while max_frames is None or count < max_frames:
                got_any = False
                try:
                    remaining = (None if max_frames is None
                                 else max_frames - count)
                    for jb in iter_mjpeg_bytes(url, max_frames=remaining):
                        got_any = True
                        count += 1
                        self._push(jb)
                    break  # clean end of stream
                except (TimeoutError, ConnectionError, OSError):
                    if not got_any or self.reconnects >= reconnects:
                        raise
                    self.reconnects += 1
                    _log.warning("live stream gap on %s — reconnecting "
                                 "(%d/%d)", url, self.reconnects, reconnects)
                    time.sleep(0.5 * self.reconnects)
        except Exception as e:  # raised in the consumer, not swallowed
            self._err = e
        finally:
            with self._cond:
                self._done = True
                self._cond.notify_all()
            if self.dropped:
                _log.info("live stream ended: %d frame(s) dropped to stay "
                          "current (consumer slower than stream)",
                          self.dropped)

    def frames(self) -> Iterator[bytes]:
        while True:
            with self._cond:
                while not self._dq and not self._done:
                    self._cond.wait(0.5)
                if self._dq:
                    jb = self._dq.popleft()
                elif self._err is not None:
                    raise self._err
                else:
                    return
            yield jb


def _chunks(reader: _StreamReader, batch_size: int, owner) -> Iterator[list]:
    """The reader's JPEGs in lists of ``batch_size`` (the last may be
    shorter), keeping ``owner.last_dropped`` up to date."""
    buf = []
    for jb in reader.frames():
        buf.append(jb)
        if len(buf) == batch_size:
            yield buf
            buf = []
        owner.last_dropped = reader.dropped
    owner.last_dropped = reader.dropped
    if buf:
        yield buf


class MjpegVideoSource:
    """Live MJPEG stream decoded on the host, in uint8 BGR batches.

    The socket is drained by a :class:`_StreamReader` thread holding
    ``max(2 * batch_size, 8)`` frames; ``last_dropped`` counts what a slow
    consumer skipped in the last ``batches`` run.
    """

    def __init__(self, url: str, max_frames: int | None = None):
        self.url = url
        self._max = max_frames
        self.last_dropped = 0

    def batches(self, batch_size: int):
        reader = _StreamReader(self.url, self._max,
                               maxlen=max(2 * batch_size, 8))
        for jpegs in _chunks(reader, batch_size, self):
            yield np.stack([decode_jpeg(jb) for jb in jpegs])


_TRANSPORTS = ("tdelta", "split", "packed")


class MjpegCudaVideoSource:
    """Live MJPEG stream decoded on the card.

    The twin of the reference's ``MjpegTpuVideoSource``: the host does only
    the native Huffman entropy decode of each received JPEG, a few bytes per
    nonzero DCT coefficient cross to ``device`` (the card by default), and
    the expand (the K8 kernel), dequantization and IDCT run there
    (``ops/jpeg.py``). ``batches`` yields float32 gray frames on the device;
    ``device_feed`` drives the split form, ``host_batches`` on its prefetch
    thread and ``to_device`` on the consumer's. Raises at construction
    without the device or a C++ compiler for the native decoder; the
    caller gets that error, not a host-decode fallback.
    """

    def __init__(self, url: str, max_frames: int | None = None,
                 transport: str = "tdelta", device=CUDA):
        """``transport``: ``tdelta`` (default: temporal coefficient deltas,
        the fewest bytes on a slowly deforming scene), ``split`` (the
        scene-independent choice) or ``packed``; every one decodes all 64
        zigzag coefficients."""
        from vision_basedsensor_tpu_torch.ops.jpeg import MjpegBatchDecoder
        if transport not in _TRANSPORTS:
            raise ValueError(
                f"transport must be tdelta|split|packed, got {transport}")
        self.url = url
        self._max = max_frames
        self._dec = MjpegBatchDecoder(device=device)
        self._transport = transport
        self.last_dropped = 0
        self.session_stats: dict | None = None

    @property
    def last_stats(self) -> dict | None:
        """Byte accounting summed over the whole session (a short last
        batch's sparsity is not the stream's); ``run-live`` prints it as
        the per-frame link cost."""
        return self.session_stats

    def _account(self, st: dict | None) -> None:
        if not st:
            return
        if self.session_stats is None:
            self.session_stats = dict(st)
            return
        for key in ("frames", "nnz", "bytes_shipped", "bytes_dense"):
            if key in st:
                self.session_stats[key] = self.session_stats.get(key, 0) + st[key]

    def _entropy(self, jpegs: list[bytes]):
        hp = getattr(self._dec, f"entropy_decode_{self._transport}")(jpegs)
        self._account(hp.stats)
        return hp

    def to_device(self, payload):
        """Device half: copy a host payload to the device and decode it (on
        the consumer's thread)."""
        return getattr(self._dec, f"{self._transport}_to_device")(payload)

    def host_batches(self, batch_size: int):
        """Host half of :meth:`batches`: the native entropy decode to numpy
        payloads, no device work (``device_feed``'s prefetch thread)."""
        reader = _StreamReader(self.url, self._max,
                               maxlen=max(2 * batch_size, 8))
        for jpegs in _chunks(reader, batch_size, self):
            yield self._entropy(jpegs)

    def batches(self, batch_size: int):
        for payload in self.host_batches(batch_size):
            yield self.to_device(payload)
