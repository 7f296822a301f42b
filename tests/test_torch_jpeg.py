"""The JPEG ingest of the PyTorch port (``ops/jpeg.py``, ``native/``,
``io/jpeg_encode.py``) vs the JAX package's ``ops/jpeg.py`` on the CPU.

The same JPEG bytes go through both decoders: the host payloads must be
equal array for array (the same C++ source, the same padding), and the
device halves bitwise equal (the dequant-IDCT is one float32 matmul in the
same zigzag order in both, and torch's CPU matmul and XLA's give the same
bits here). Within the port every transport equals the dense one bitwise.
"""
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from vision_basedsensor_tpu.ops import jpeg as jj

from vision_basedsensor_tpu_torch import native
from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
from vision_basedsensor_tpu_torch.ops import jpeg as tj
from vision_basedsensor_tpu_torch.ops.cuda import expand as kx

cv2 = pytest.importorskip("cv2")
ROOT = Path(__file__).resolve().parents[1]


def _textured(h, w, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    img = (np.add.outer(np.sin((np.arange(h) + shift) / 13.0),
                        np.cos(np.arange(w) / 29.0)) * 55 + 120)
    img += rng.normal(0, 9, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def _stream(kind):
    """Six frames of a slowly moving scene: gray q70 at an unaligned size,
    gray q95 (large coefficients, so every spill stream is used) and colour
    4:2:0 q70 (the capture server's format)."""
    if kind == "gray q70":
        frames = [_textured(45, 77, 0, s) for s in np.arange(6) * 0.3]
        return [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 70])[1]
                .tobytes() for f in frames]
    if kind == "gray q95":
        frames = [_textured(48, 80, 1, s) for s in np.arange(6) * 2.0]
        frames[3] = np.roll(frames[3], 17, axis=1)   # a DC jump mid-batch
        return [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 95])[1]
                .tobytes() for f in frames]
    frames = [cv2.cvtColor(_textured(48, 64, 2, s), cv2.COLOR_GRAY2BGR)
              for s in np.arange(6) * 0.5]
    return [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 70])[1]
            .tobytes() for f in frames]


STREAMS = ("gray q70", "gray q95", "color 420")
HOST_CASES = [("dense", 1, 64), ("packed", 1, 64), ("packed", 4, 64),
              ("split", 1, 64), ("split", 4, 64), ("split", 1, 15),
              ("split", 4, 15), ("tdelta", 1, 64), ("tdelta", 4, 64),
              ("tdelta", 1, 15), ("tdelta", 4, 15)]


def _host(dec, transport, jpegs, zmax):
    fn = getattr(dec, f"entropy_decode_{transport}")
    return fn(jpegs, zmax) if transport in ("split", "tdelta") else fn(jpegs)


def test_native_source_is_the_reference_copy():
    def sha(p):
        return hashlib.sha256(p.read_bytes()).hexdigest()
    assert (sha(ROOT / "vision_basedsensor_tpu_torch" / "native"
                / "jpeg_coeffs.cpp")
            == sha(ROOT / "vision_basedsensor_tpu" / "native"
                   / "jpeg_coeffs.cpp"))


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("transport,workers,zmax", HOST_CASES)
def test_host_payloads_match_jax(stream, transport, workers, zmax):
    jpegs = _stream(stream)
    want = _host(jj.MjpegBatchDecoder(workers=workers), transport, jpegs, zmax)
    got = _host(tj.MjpegBatchDecoder(workers=workers, device="cpu"),
                transport, jpegs, zmax)
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    if stream == "gray q95" and transport != "dense":
        assert (got.sdeltas != 0).any()    # the spill stream is exercised


def _jax_frames(dec, hp):
    import jax.numpy as jnp
    a = [jnp.asarray(x) for x in hp if isinstance(x, np.ndarray)]
    if isinstance(hp, jj.HostDense):
        return jj.idct_frames(*a, height=hp.height, width=hp.width)
    kw = dict(height=hp.height, width=hp.width, grid=hp.grid)
    if isinstance(hp, jj.HostPacked):
        return jj.delta_idct_frames(*a, **kw)
    if isinstance(hp, jj.HostSplit):
        return jj.split_idct_frames(*a, **kw, zmax=hp.zmax)
    return jj.tdelta_idct_frames(*a, **kw, zmax=hp.zmax)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("transport,zmax", [("dense", 64), ("packed", 64),
                                            ("split", 64), ("split", 15),
                                            ("tdelta", 64), ("tdelta", 15)])
def test_device_half_matches_jax_bitwise(stream, transport, zmax):
    jpegs = _stream(stream)
    jdec = jj.MjpegBatchDecoder(workers=1)
    want = np.asarray(_jax_frames(jdec, _host(jdec, transport, jpegs, zmax)))
    tdec = tj.MjpegBatchDecoder(workers=1, device="cpu")
    hp = _host(tdec, transport, jpegs, zmax)
    got = getattr(tdec, f"{transport}_to_device")(hp)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stream", STREAMS)
def test_port_transports_equal_dense(stream):
    """Every transport bitwise equal to the dense one at zmax=64; the band
    limit equal to the dense decode with zigzag indices >= zmax zeroed.
    A CPU decode launches no kernel."""
    jpegs = _stream(stream)
    dec = tj.MjpegBatchDecoder(workers=1, device="cpu")
    hd = dec.entropy_decode_dense(jpegs)
    dense = dec.dense_to_device(hd)
    before = kx.launches
    for transport in ("packed", "split", "tdelta"):
        got = getattr(dec, f"{transport}_to_device")(
            _host(dec, transport, jpegs, 64))
        assert torch.equal(got, dense), transport
    assert kx.launches == before
    for zmax in (2, 15):
        zeroed = hd.coeffs.reshape(-1, 64).copy()
        zeroed[:, tj._ZIGZAG[zmax:]] = 0
        want = tj.idct_frames(torch.from_numpy(zeroed.reshape(hd.coeffs.shape)),
                              torch.from_numpy(hd.qtables), height=hd.height,
                              width=hd.width)
        for transport in ("split", "tdelta"):
            got = getattr(dec, f"{transport}_to_device")(
                _host(dec, transport, jpegs, zmax))
            assert torch.equal(got, want), (transport, zmax)


@pytest.mark.parametrize("quality", [30, 70, 95])
@pytest.mark.parametrize("shape", [(480, 640), (41, 67)])
def test_encoder_output_decodes_like_libjpeg(quality, shape):
    """The port's encoder makes baseline JPEGs that libjpeg reads, and the
    port's decode of them is within libjpeg's IDCT rounding
    (tests/test_jpeg.py:100's bound)."""
    img = _textured(*shape, seed=4)
    data = encode_jpeg(img, quality)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    ref = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_GRAYSCALE).astype(np.float32)
    assert ref.shape == shape
    dec = tj.MjpegBatchDecoder(workers=1, device="cpu")
    out = dec.tdelta_to_device(dec.entropy_decode_tdelta([data]))[0].numpy()
    d = np.abs(out - ref)
    assert d.max() <= 2.0 and d.mean() < 0.2, (d.max(), d.mean())
    # Quantized as libjpeg does: the encoded size is close to cv2's.
    size_cv2 = len(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                              quality])[1])
    assert abs(len(data) - size_cv2) <= 0.05 * size_cv2


def test_encoder_rejects_bad_input():
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((8, 8), np.uint8), quality=0)


@pytest.mark.parametrize("transport", ["dense", "packed", "split", "tdelta"])
def test_malformed_frame_raises(transport):
    jpegs = _stream("gray q70")
    jpegs[2] = jpegs[2][:40]                  # truncated mid-header
    with pytest.raises(ValueError):
        _host(jj.MjpegBatchDecoder(workers=1), transport, jpegs, 64)
    with pytest.raises(ValueError):
        _host(tj.MjpegBatchDecoder(workers=1, device="cpu"), transport, jpegs,
              64)


def test_decoder_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tj.MjpegBatchDecoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tj.MjpegBatchDecoder()


def test_native_loader_raises_without_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native._build()


def test_native_loader_raises_with_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="build failed") as e:
        native._build()
    assert "error" in str(e.value)
    assert not list(tmp_path.glob("*.so*"))      # nothing half-published


def test_native_library_builds_once_per_source():
    path = native.library_path()
    lib = native.load_jpeg_lib()
    assert path.exists() and native.load_jpeg_lib() is lib
    assert path.parent == ROOT / "build" / "vbs_torch_native"


def test_table_library_builds_once_per_source():
    """The table formatter is a library of its own: loading it leaves the
    decoder's path and library as they were."""
    jpeg_path, jpeg_lib = native.library_path(), native.load_jpeg_lib()
    path = native.table_library_path()
    lib = native.load_table_lib()
    assert path.exists() and native.load_table_lib() is lib
    assert path.parent == ROOT / "build" / "vbs_torch_native"
    assert path != jpeg_path and lib is not jpeg_lib
    assert native.library_path() == jpeg_path
    assert native.load_jpeg_lib() is jpeg_lib


def test_last_stats_records_each_batch():
    """``last_stats`` is the byte accounting of the most recent batch."""
    jpegs = _stream("gray q70")
    dec = tj.MjpegBatchDecoder(workers=1, device="cpu")
    for transport in ("dense", "packed", "split", "tdelta"):
        hp = _host(dec, transport, jpegs, 64)
        assert dec.last_stats is hp.stats
        assert hp.stats["transport"] == transport
        assert hp.stats["frames"] == len(jpegs)
