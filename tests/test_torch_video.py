"""The PyTorch port's video ingest (``io/video.py``: the MJPEG AVI muxer,
``MjpegAviCudaSource``, ``device_feed``) and ``StreamingPipeline.run`` vs
the JAX package's ``io/video.py`` and pipeline, on the CPU.

Frames are rendered by the JAX synth at 240x320, encoded at q70 with the
port's encoder and muxed into an ``.avi``; the same file feeds both
packages.
"""
import numpy as np
import pytest
import torch

import jax

from torch_parity import np_, render_jax

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu import pipeline as jpipe
from vision_basedsensor_tpu.io import video as jvideo

from vision_basedsensor_tpu_torch import convert
from vision_basedsensor_tpu_torch import pipeline as tpipe
from vision_basedsensor_tpu_torch.io import video as tvideo
from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg

H, W, B = 240, 320, 8


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = np.zeros((B, 65, 3), np.float32)
    d[:, :, 2] = -0.05 * np.arange(B)[:, None]
    frames, scene = render_jax(H, W, d)
    frames = frames.astype(np.uint8)
    jpegs = [encode_jpeg(f, 70) for f in frames]
    path = str(tmp_path_factory.mktemp("clip") / "clip.avi")
    wr = tvideo.MjpegAviWriter(path, 12.0, (W, H))
    for j in jpegs:
        wr.write_jpeg(j)
    wr.close()
    assert wr.frames_written == B
    return dict(path=path, jpegs=jpegs, frames=frames, scene=scene)


def test_avi_writer_matches_jax_and_round_trips(clip, tmp_path):
    jpath = str(tmp_path / "jax.avi")
    wr = jvideo.MjpegAviWriter(jpath, 12.0, (W, H))
    for j in clip["jpegs"]:
        wr.write_jpeg(j)
    wr.close()
    with open(clip["path"], "rb") as f:
        buf = f.read()
    with open(jpath, "rb") as f:
        assert f.read() == buf              # the same container, byte for byte
    assert list(tvideo._iter_avi_video_chunks(buf)) == clip["jpegs"]
    with pytest.raises(ValueError, match="movi"):
        list(tvideo._iter_avi_video_chunks(b"RIFF0000AVI "))


@pytest.mark.parametrize("transport", ["tdelta", "split", "packed", "dense"])
def test_cuda_source_matches_tpu_source(clip, transport):
    """The same frames, bit for bit, batch by batch, with the same byte
    accounting."""
    jsrc = jvideo.MjpegAviTpuSource(clip["path"], transport=transport)
    tsrc = tvideo.MjpegAviCudaSource(clip["path"], transport=transport,
                                     device="cpu")
    want = [np.asarray(b) for b in jsrc.batches(3)]
    got = [np_(b) for b in tsrc.batches(3)]
    assert [g.shape for g in got] == [(3, H, W), (3, H, W), (2, H, W)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tsrc.last_stats == jsrc.last_stats


def test_cuda_source_rejects_bad_arguments(clip, tmp_path):
    with pytest.raises(ValueError, match="transport"):
        tvideo.MjpegAviCudaSource(clip["path"], transport="raw", device="cpu")
    with pytest.raises(ValueError, match="zmax"):
        tvideo.MjpegAviCudaSource(clip["path"], transport="dense", zmax=15,
                                  device="cpu")
    other = tmp_path / "x.avi"
    wr = tvideo.MjpegAviWriter(str(other), 12.0, (W, H))
    wr.write_jpeg(b"not a jpeg")
    wr.close()
    with pytest.raises(ValueError, match="not an MJPEG AVI"):
        tvideo.MjpegAviCudaSource(str(other), device="cpu")


def test_device_feed_yields_all_frames():
    frames = np.arange(12 * 4 * 4, dtype=np.uint8).reshape(12, 4, 4)
    got = list(tvideo.device_feed(tvideo.ArrayVideoSource(frames), 5,
                                  device="cpu"))
    assert [tuple(b.shape) for b in got] == [(5, 4, 4), (5, 4, 4), (2, 4, 4)]
    assert all(isinstance(b, torch.Tensor) for b in got)
    np.testing.assert_array_equal(np.concatenate([np_(b) for b in got]),
                                  frames)


def test_device_feed_decodes_an_avi_in_order(clip):
    src = tvideo.MjpegAviCudaSource(clip["path"], device="cpu")
    fed = [np_(b) for b in tvideo.device_feed(src, 3, device="cpu")]
    np.testing.assert_array_equal(
        np.concatenate(fed), np.concatenate([np_(b) for b in src.batches(3)]))


def test_device_feed_propagates_source_errors():
    """A source error crosses the prefetch thread: each good batch exactly
    once, then the error (tests/test_io.py:160)."""

    class FlakySource:
        def batches(self, batch_size):
            yield np.zeros((2, 8, 8), np.uint8)
            yield np.ones((2, 8, 8), np.uint8)
            raise ValueError("JPEG batch decode failed")

    got = []
    with pytest.raises(ValueError, match="decode failed"):
        for b in tvideo.device_feed(FlakySource(), 2, device="cpu"):
            got.append(float(b.float().mean()))
    assert got == [0.0, 1.0], got


def test_device_feed_propagates_a_corrupt_frame(clip, tmp_path):
    path = str(tmp_path / "bad.avi")
    wr = tvideo.MjpegAviWriter(path, 12.0, (W, H))
    for i, j in enumerate(clip["jpegs"]):
        wr.write_jpeg(j[:40] if i == 4 else j)   # truncated mid-header
    wr.close()
    src = tvideo.MjpegAviCudaSource(path, device="cpu")
    got = []
    with pytest.raises(ValueError, match="JPEG"):
        for b in tvideo.device_feed(src, 3, device="cpu"):
            got.append(b.shape[0])
    assert got == [3]


def test_synthetic_source_yields_rendered_uint8():
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames

    scene = default_scene(64, 96, device="cpu")
    d = np.zeros((3, 65, 3), np.float32)
    d[:, :, 2] = -0.1 * np.arange(3)[:, None]
    got = list(tvideo.SyntheticVideoSource(scene, d).batches(2))
    assert [b.dtype for b in got] == [np.uint8, np.uint8]
    want = render_frames(scene, torch.from_numpy(d)).to(torch.uint8).numpy()
    np.testing.assert_array_equal(np.concatenate(got), want)


def test_streaming_run_over_avi(clip):
    """``StreamingPipeline.run`` over the AVI: equal to ``process`` on the
    decoded chunks, and to the JAX ``StreamingPipeline.run`` on the same
    file within tests/test_torch_stream.py's tolerances."""
    jc = jcfg.PipelineConfig(reconstruct=jcfg.ReconstructConfig(
        warmup_frames=0))
    tc = convert.config_from_jax(jc)
    cam = convert.camera_from_numpy(clip["scene"].cam, device="cpu")
    src = tvideo.MjpegAviCudaSource(clip["path"], device="cpu")
    outs = list(tpipe.StreamingPipeline(cam, tc, device="cpu").run(src, 3))
    assert [o.tracked.valid.shape[0] for o in outs] == [3, 3, 2]
    sp = tpipe.StreamingPipeline(cam, tc, device="cpu")
    direct = [sp.process(b) for b in src.batches(3)]
    for o, d in zip(outs, direct):
        for name in ("xy", "axes", "valid"):
            assert torch.equal(getattr(o.tracked, name),
                               getattr(d.tracked, name)), name
        assert torch.equal(o.recon.cum_path, d.recon.cum_path)

    jsp = jpipe.StreamingPipeline(clip["scene"].cam, jc)
    jouts = [jax.block_until_ready(o) for o in jsp.run(
        jvideo.MjpegAviTpuSource(clip["path"]), 3)]

    def cat(xs, get):
        return np.concatenate([np_(get(x)) for x in xs])

    v = cat(jouts, lambda o: o.tracked.valid)
    np.testing.assert_array_equal(cat(outs, lambda o: o.tracked.valid), v)
    # At 240x320 the q70 stream costs the outermost ring a few markers in
    # both packages alike (observed 61 of 65 in every frame).
    assert v.sum(-1).min() >= 60
    # tests/test_torch_stream.py's tolerances hold for all but two markers:
    # on JPEG noise their NCC peaks have near-equal pixels, and the last-bit
    # difference of the NCC field picks the other one in one frame, moving
    # the window by a pixel (observed 0.053 px in xy, 0.076 px in axes,
    # 0.032 mm in cum_path, which carries it into later frames).
    for get, tol in ((lambda o: o.tracked.xy, 1e-3),
                     (lambda o: o.tracked.axes, 1e-3),
                     (lambda o: o.recon.cum_path, 5e-4),
                     (lambda o: o.recon.from_first_norm, 5e-4)):
        d = np.abs(cat(outs, get) - cat(jouts, get))
        d = d.reshape(d.shape[0], d.shape[1], -1).max(-1)   # (frame, marker)
        assert len(np.unique(np.nonzero(d > tol)[1])) <= 2
        assert d.max() <= 0.1


def test_ingest_defaults_to_the_card(clip):
    """``MjpegAviCudaSource`` and ``device_feed`` build on the card unless
    told otherwise, and raise without one."""
    frames = np.zeros((2, 4, 4), np.uint8)
    if torch.cuda.is_available():
        src = tvideo.MjpegAviCudaSource(clip["path"])
        assert next(src.batches(2)).device.type == "cuda"
        assert next(tvideo.device_feed(tvideo.ArrayVideoSource(frames),
                                       2)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tvideo.MjpegAviCudaSource(clip["path"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(tvideo.device_feed(tvideo.ArrayVideoSource(frames), 2))
