"""Video sources, the MJPEG AVI muxer and the double-buffered device feed.

Port of ``vision_basedsensor_tpu/io/video.py``: ``VideoSource``,
``ArrayVideoSource``, ``SyntheticVideoSource`` (the port's renderer), the
RIFF walk ``_iter_avi_video_chunks``, ``MjpegAviWriter``,
``MjpegAviCudaSource`` (the twin of ``MjpegAviTpuSource``: host entropy
decode, dequant-IDCT on the card) and ``device_feed``, and the host-decode
sources and sink: ``FileVideoSource`` (cv2, sequential), ``MjpegAviSource``
(cv2 on a thread pool) and ``VideoWriter``. These three import cv2 only
when they are built, so the module imports without it.
"""
from __future__ import annotations

import functools
import struct
import threading
from typing import Iterator

import numpy as np
import torch

from vision_basedsensor_tpu_torch.core.device import CUDA, resolve
from vision_basedsensor_tpu_torch.utils.profiling import trace_annotation


@functools.cache
def _cv2():
    """cv2, or None where opencv-python is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def decode_jpeg(buf: bytes) -> np.ndarray:
    """One JPEG as a BGR uint8 image: cv2 where installed, else PIL. PIL's
    image is converted to RGB first, so a gray JPEG also gives three
    channels (the JAX package's fallback reverses a gray frame's columns)."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    from io import BytesIO

    from PIL import Image
    return np.asarray(Image.open(BytesIO(buf)).convert("RGB"))[..., ::-1].copy()


class VideoSource:
    """Iterator of frame batches ``(B, H, W)`` or ``(B, H, W, 3)`` uint8."""

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        raise NotImplementedError

    @property
    def fps(self) -> float:
        return 0.0


class ArrayVideoSource(VideoSource):
    """Frames from an in-memory array or .npy/.npz file."""

    def __init__(self, frames_or_path, fps: float = 12.0):
        if isinstance(frames_or_path, str):
            if frames_or_path.endswith(".npz"):
                with np.load(frames_or_path) as z:
                    frames = z[list(z.keys())[0]]
            else:
                frames = np.load(frames_or_path)
        else:
            frames = np.asarray(frames_or_path)
        self._frames = frames
        self._fps = fps

    @property
    def fps(self) -> float:
        return self._fps

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        for i in range(0, len(self._frames), batch_size):
            yield self._frames[i:i + batch_size]


class FileVideoSource(VideoSource):
    """Decode a video file via OpenCV (reference input path,
    ``marker_detection.py:52``)."""

    def __init__(self, path: str):
        cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("FileVideoSource requires cv2 (opencv-python)")
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"Could not open video: {path}")
        self._fps = self._cap.get(cv2.CAP_PROP_FPS)

    @property
    def fps(self) -> float:
        return self._fps

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        buf = []
        while True:
            ok, frame = self._cap.read()
            if not ok:
                break
            buf.append(frame)
            if len(buf) == batch_size:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)
        self._cap.release()


class SyntheticVideoSource(VideoSource):
    """Rendered dome frames for a prescribed displacement sequence
    ``(T, 65, 3)``, rendered on the scene's device and yielded as uint8."""

    def __init__(self, scene, displacements, fps: float = 12.0):
        self._scene = scene
        self._disp = np.asarray(displacements)
        self._fps = fps

    @property
    def fps(self) -> float:
        return self._fps

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        from vision_basedsensor_tpu_torch.synth import render_frames
        dev = self._scene.cam.fx.device
        for i in range(0, len(self._disp), batch_size):
            chunk = torch.as_tensor(self._disp[i:i + batch_size],
                                    dtype=torch.float32, device=dev)
            yield render_frames(self._scene, chunk).to(torch.uint8).cpu().numpy()


def _iter_avi_video_chunks(buf: bytes):
    """Yield raw stream-0 video frame payloads from an AVI byte buffer.

    Minimal RIFF walk of the 'movi' list: chunks are fourcc + LE32 size +
    data (padded to even); video frames are '..dc'/'..db' chunks; 'rec '
    LISTs are descended into; 'idx1' ends the stream.
    """
    i = buf.find(b"movi")
    if i < 0:
        raise ValueError("no 'movi' list found (not an AVI?)")
    pos = i + 4
    end = len(buf)
    while pos + 8 <= end:
        cc = buf[pos:pos + 4]
        size = int.from_bytes(buf[pos + 4:pos + 8], "little")
        if cc == b"idx1":
            return
        if cc == b"LIST":
            pos += 12  # descend (skip the list-type fourcc)
            continue
        if cc[2:4] in (b"dc", b"db") and size > 0:
            yield buf[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


class MjpegAviSource(VideoSource):
    """Parallel host decode of MJPG ``.avi`` files.

    Motion-JPEG frames are independent, so this source demuxes the AVI
    itself (RIFF chunk walk) and decodes the JPEGs on a thread pool
    (``cv2.imdecode`` releases the GIL; PIL where cv2 is absent), with a
    lookahead of two batches, on one thread per host core (at most 32).
    Frames are BGR uint8 at the recorder's 12 fps.
    """

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._buf = f.read()
        first = next(_iter_avi_video_chunks(self._buf), None)
        if first is None or not first.startswith(b"\xff\xd8"):
            raise ValueError(f"{path}: not an MJPEG AVI (use FileVideoSource)")

    @property
    def fps(self) -> float:
        return 12.0

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        import os
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        from itertools import islice

        # Lazy submission with a bounded lookahead: Executor.map would
        # submit every frame up front, so an abandoned generator would keep
        # decoding frames nobody reads.
        chunks = iter(_iter_avi_video_chunks(self._buf))
        buf = []
        with ThreadPoolExecutor(min(32, os.cpu_count() or 4)) as ex:
            pending = deque(ex.submit(decode_jpeg, c)
                            for c in islice(chunks, 2 * batch_size))
            while pending:
                frame = pending.popleft().result()
                nxt = next(chunks, None)
                if nxt is not None:
                    pending.append(ex.submit(decode_jpeg, nxt))
                buf.append(frame)
                if len(buf) == batch_size:
                    yield np.stack(buf)
                    buf = []
        if buf:
            yield np.stack(buf)


_TRANSPORTS = ("tdelta", "split", "packed", "dense")


class MjpegAviCudaSource(VideoSource):
    """MJPEG ``.avi`` -> gray frames decoded on the card.

    The twin of the reference's ``MjpegAviTpuSource`` (its ``--tpu-decode``
    ingest): the only host work per frame is the native Huffman entropy
    decode (``ops/jpeg.py``, ``native/jpeg_coeffs.cpp``); the expand (the K8
    kernel), dequantization, the 8x8 IDCT and reassembly run batched on
    ``device`` (the card by default). ``batches`` yields float32 frames on
    the device. Raises at construction without the device or without a
    C++ compiler for the native decoder.
    """

    def __init__(self, path: str, fps: float = 12.0,
                 transport: str = "tdelta", zmax: int = 64, device=CUDA):
        """``transport``: ``tdelta`` (default: temporal coefficient deltas,
        a few KB/frame on a slowly deforming scene), ``split`` (DC/AC
        separated VLC streams, the scene-independent choice), ``packed``
        (2-byte delta pairs) or ``dense`` (the full coefficient tensor).
        ``zmax`` (split/tdelta, 2..64): zigzag band limit; 64 decodes
        exactly."""
        from vision_basedsensor_tpu_torch.ops.jpeg import MjpegBatchDecoder
        if transport not in _TRANSPORTS:
            raise ValueError(f"transport must be tdelta|split|packed|dense, "
                             f"got {transport}")
        if zmax != 64 and transport not in ("split", "tdelta"):
            raise ValueError(
                "zmax band limit requires transport='split'|'tdelta'")
        device = resolve(device)
        with trace_annotation("vbs.feed.open"):
            with open(path, "rb") as f:
                self._buf = f.read()
            first = next(_iter_avi_video_chunks(self._buf), None)
            if first is None or not first.startswith(b"\xff\xd8"):
                raise ValueError(f"{path}: not an MJPEG AVI")
            self._dec = MjpegBatchDecoder(device=device)
        self._transport = transport
        self._zmax = zmax
        self._fps = fps

    @property
    def fps(self) -> float:
        return self._fps

    @property
    def last_stats(self) -> dict | None:
        """Byte accounting of the most recent batch (``ops/jpeg.py``)."""
        return self._dec.last_stats

    def host_batches(self, batch_size: int):
        """Host half of :meth:`batches`: the native entropy decode to numpy
        payloads, no device work — what ``device_feed`` runs on its
        prefetch thread. Pair with :meth:`to_device`."""
        dec = getattr(self._dec, f"entropy_decode_{self._transport}")
        kw = {"zmax": self._zmax} if self._transport in ("split",
                                                          "tdelta") else {}
        chunks = []
        for c in _iter_avi_video_chunks(self._buf):
            chunks.append(c)
            if len(chunks) == batch_size:
                yield dec(chunks, **kw)
                chunks = []
        if chunks:
            yield dec(chunks, **kw)

    def to_device(self, payload):
        """Device half: copy a host payload to the device and decode it."""
        return getattr(self._dec, f"{self._transport}_to_device")(payload)

    def batches(self, batch_size: int):
        for payload in self.host_batches(batch_size):
            yield self.to_device(payload)


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


class VideoWriter:
    """Annotated-video sink: an XVID .avi, as ``marker_detection.py:70-76``
    writes. Raises where cv2 is absent or cannot open the file (the JAX
    package's writer does nothing there)."""

    def __init__(self, path: str, fps: float, size_wh: tuple[int, int]):
        cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("VideoWriter requires cv2 (opencv-python)")
        self._writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"),
                                       fps, size_wh)
        if not self._writer.isOpened():
            raise IOError(f"cv2 could not open {path} for XVID writing")

    def write(self, frame: np.ndarray) -> None:
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        self._writer.write(frame.astype(np.uint8))

    def close(self) -> None:
        self._writer.release()


def _host_to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A raw frame batch on ``device``: copied from pinned memory without
    blocking the host when the device is a card."""
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_feed(source: VideoSource, batch_size: int,
                device=CUDA) -> Iterator[torch.Tensor]:
    """Double-buffered host -> device frame feed.

    Decodes batch k+1 on a host thread while batch k is on the device, and
    yields tensors on ``device`` (the card by default). Sources that decode
    on the device (``MjpegAviCudaSource``) expose a split API:
    ``host_batches`` runs only the native entropy decode (on the prefetch
    thread) and ``to_device`` copies the payload and issues the device
    decode (on this, the consumer's, thread). Raw sources are copied from
    pinned memory with ``non_blocking=True``.

    One batch of device lookahead: batch k+1's copy and decode are issued
    before batch k is yielded, so they queue behind the consumer's work on
    the stream instead of after it. A decode error crosses the thread: the
    batch decoded before the failure is delivered, then the error is
    raised, and each batch goes out exactly once.
    """
    device = resolve(device)
    to_dev = getattr(source, "to_device", None)
    it = (source.host_batches(batch_size) if to_dev is not None
          else source.batches(batch_size))
    lock = threading.Lock()
    state: dict = {}

    def prefetch():
        # A failure that only killed this thread would leave the previous
        # batch in state["next"], and the consumer would yield it twice.
        try:
            nxt, err = next(it), None
        except StopIteration:
            nxt, err = None, None
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            nxt, err = None, e
        with lock:
            state["next"] = nxt
            state["err"] = err

    t = threading.Thread(target=prefetch)
    t.start()
    pending = None
    while True:
        with trace_annotation("vbs.feed.wait"):
            t.join()
        with lock:
            batch = state.get("next")
            err = state.get("err")
        if err is not None:
            if pending is not None:
                yield pending
            raise err
        if batch is None:
            if pending is not None:
                yield pending
            return
        t = threading.Thread(target=prefetch)
        t.start()
        with trace_annotation("vbs.feed.device_decode"):
            arr = (to_dev(batch) if to_dev is not None
                   else _host_to_device(batch, device))
        if pending is not None:
            yield pending
        pending = arr
