"""Undistortion, sequential association, StreamingPipeline and sessions of the
PyTorch port vs the JAX package, on the CPU.

Frames are rendered by the JAX synth through a distorted camera and go
through both packages with ``undistort_frames=True`` and
``association_mode="sequential"``. Chunked streams must equal one batch to
1e-4 (the JAX promise, tests/test_streaming.py:48-51); the two packages
agree to the pipeline tolerances of tests/test_torch_pipeline.py (the NCC
field differs in the last float32 bits).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import np_, to_jax, to_torch

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu import pipeline as jpipe
from vision_basedsensor_tpu.core.camera import CameraModel as JCamera
from vision_basedsensor_tpu.core import undistort as jund
from vision_basedsensor_tpu.io import session as jsession
from vision_basedsensor_tpu.synth import default_scene as jscene
from vision_basedsensor_tpu.synth import render_frames as jrender
from vision_basedsensor_tpu.track.associate import \
    associate_sequential as jassoc_seq

from vision_basedsensor_tpu_torch import convert
from vision_basedsensor_tpu_torch import pipeline as tpipe
from vision_basedsensor_tpu_torch.core import undistort as tund
from vision_basedsensor_tpu_torch.detect.detector import Detections
from vision_basedsensor_tpu_torch.io import session as tsession
from vision_basedsensor_tpu_torch.track.associate import \
    associate_sequential as tassoc_seq

H, W, B = 240, 320, 12
DIST = np.array([-0.18, 0.05, 0.0, 0.0, 0.0])   # tests/test_undistort.py:88


def _render(dist, d):
    scene = jscene(H, W, dist=dist)
    return np.asarray(jrender(scene, jnp.asarray(d)), np.float32), scene


def _cat(outs, get):
    return np.concatenate([np_(get(o)) for o in outs])


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """One JAX StreamingPipeline over two chunks of 6 (its session saved
    after the first), and the port's configuration and camera."""
    d = np.zeros((B, 65, 3), np.float32)
    d[:, :, 2] = -0.05 * np.arange(B)[:, None]
    frames, scene = _render(DIST, d)
    jc = jcfg.PipelineConfig(
        undistort_frames=True,
        track=jcfg.TrackConfig(association_mode="sequential"),
        reconstruct=jcfg.ReconstructConfig(warmup_frames=0))
    sp = jpipe.StreamingPipeline(scene.cam, jc)
    jouts = [jax.block_until_ready(sp.process(to_jax(frames[:6])))]
    jdir = tmp_path_factory.mktemp("jax_session")
    jsession.save_session(str(jdir), sp.ref, jc, scan_carry=sp.carry,
                          assoc_xy=sp.assoc_xy, frames_seen=sp.frames_seen)
    jouts.append(jax.block_until_ready(sp.process(to_jax(frames[6:]))))
    return dict(frames=frames, scene=scene, jc=jc,
                tc=convert.config_from_jax(jc),
                cam=convert.camera_from_numpy(scene.cam, device="cpu"),
                jouts=jouts, jdir=jdir)


def _port_chunks(s, sizes, cfg=None, **kw):
    sp = tpipe.StreamingPipeline(s["cam"], cfg or s["tc"], device="cpu", **kw)
    outs, i = [], 0
    for n in sizes:
        outs.append(sp.process(s["frames"][i:i + n]))   # numpy in
        i += n
    return sp, outs


def test_chunks_equal_one_batch(stream):
    batch = tpipe.run_video(to_torch(stream["frames"]), stream["cam"],
                            stream["tc"], apply_warmup=False)
    assert int(batch.tracked.valid.sum(-1).min()) >= 50
    # Observed equal to the last bit on the CPU.
    for sizes in [(4, 4, 4), (7, 5), (1, 11)]:
        _, outs = _port_chunks(stream, sizes)
        np.testing.assert_array_equal(
            _cat(outs, lambda o: o.tracked.valid), np_(batch.tracked.valid))
        for get in (lambda o: o.tracked.axes, lambda o: o.recon.cum_path,
                    lambda o: o.recon.from_first_norm):
            np.testing.assert_allclose(_cat(outs, get), np_(get(batch)),
                                       atol=1e-4)


def test_chunks_match_jax_streaming(stream):
    _, outs = _port_chunks(stream, (6, 6))
    jouts = stream["jouts"]
    v = _cat(jouts, lambda o: o.tracked.valid)
    np.testing.assert_array_equal(_cat(outs, lambda o: o.tracked.valid), v)
    assert v.sum(-1).min() >= 50       # the alpha=0 crop drops the outer ring
    # Observed 1.5e-5 px (xy), 4e-6 px (axes), 1.3e-5 mm (cum_path).
    for get, tol in ((lambda o: o.tracked.xy, 1e-3),
                     (lambda o: o.tracked.axes, 1e-3),
                     (lambda o: o.recon.cum_path, 5e-4),
                     (lambda o: o.recon.from_first_norm, 5e-4)):
        np.testing.assert_allclose(_cat(outs, get), _cat(jouts, get), atol=tol)


def test_jax_session_resumes_in_the_port(stream):
    sess = tsession.load_session(str(stream["jdir"]), device="cpu")
    assert sess.frames_seen == 6 and sess.calibration is None
    sp = tpipe.StreamingPipeline(stream["cam"], sess.config, ref=sess.ref,
                                 carry=sess.scan_carry or None,
                                 assoc_xy=sess.assoc_xy,
                                 frames_seen=sess.frames_seen, device="cpu")
    out = sp.process(stream["frames"][6:])
    jout = stream["jouts"][1]
    np.testing.assert_array_equal(np_(out.tracked.valid),
                                  np.asarray(jout.tracked.valid))
    np.testing.assert_allclose(np_(out.recon.cum_path),
                               np.asarray(jout.recon.cum_path), atol=5e-4)


def test_port_session_resumes_in_jax(stream, tmp_path):
    sp, (first,) = _port_chunks(stream, (6,))
    tsession.save_session(str(tmp_path), sp.ref, sp.cfg, scan_carry=sp.carry,
                          assoc_xy=sp.assoc_xy, frames_seen=sp.frames_seen)
    rest = sp.process(stream["frames"][6:])
    sess = jsession.load_session(str(tmp_path))
    assert sess.frames_seen == 6 and sess.config == stream["jc"]
    jsp = jpipe.StreamingPipeline(stream["scene"].cam, sess.config,
                                  ref=sess.ref, carry=sess.scan_carry or None,
                                  assoc_xy=sess.assoc_xy,
                                  frames_seen=sess.frames_seen)
    jout = jsp.process(to_jax(stream["frames"][6:]))
    np.testing.assert_array_equal(np.asarray(jout.tracked.valid),
                                  np_(rest.tracked.valid))
    np.testing.assert_allclose(np.asarray(jout.recon.cum_path),
                               np_(rest.recon.cum_path), atol=5e-4)


def test_resume_keeps_the_global_warmup_offset(stream, tmp_path):
    """A warm-up-enabled session resumed from a checkpoint masks the first
    ``warmup_frames`` frames once, globally (tests/test_streaming.py:105)."""
    cfg = dataclasses.replace(
        stream["tc"], reconstruct=dataclasses.replace(
            stream["tc"].reconstruct, warmup_frames=3))
    sp, (out1,) = _port_chunks(stream, (5,), cfg=cfg, apply_warmup=True)
    tsession.save_session(str(tmp_path), sp.ref, cfg, scan_carry=sp.carry,
                          assoc_xy=sp.assoc_xy, frames_seen=sp.frames_seen)
    sess = tsession.load_session(str(tmp_path), device="cpu")
    sp2 = tpipe.StreamingPipeline(stream["cam"], sess.config, ref=sess.ref,
                                  carry=sess.scan_carry, assoc_xy=sess.assoc_xy,
                                  apply_warmup=True,
                                  frames_seen=sess.frames_seen, device="cpu")
    out2 = sp2.process(stream["frames"][5:])
    seen = np.concatenate([np_(out1.recon.seen), np_(out2.recon.seen)])
    base = tpipe.run_video(to_torch(stream["frames"]), stream["cam"], cfg,
                           apply_warmup=True)
    np.testing.assert_array_equal(seen, np_(base.recon.seen))
    assert not seen[:3].any() and (seen[3:].sum(-1) >= 50).all()


def test_shape_change_mid_session_raises(stream):
    sp, _ = _port_chunks(stream, (2,))
    with pytest.raises(ValueError, match="frame shape changed"):
        sp.process(stream["frames"][2:4, :, :-8])


def test_rectify_map_and_remap_match_jax():
    """At 240x320 through a strongly distorted camera: the new camera, the
    map (1e-4 px) and the remapped frames (1e-3 gray levels)."""
    dist = np.array([-0.25, 0.08, 0.001, -0.001, 0.0])
    jcam = JCamera.create(300.0, 300.0, 160.0, 120.0, dist=jnp.asarray(dist))
    tcam = convert.camera_from_numpy(jcam, device="cpu")
    jnew = jund.optimal_new_camera(jcam, H, W, alpha=0.0)
    tnew = tund.optimal_new_camera(tcam, H, W, alpha=0.0)
    for name in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(np_(getattr(tnew, name)),
                                   np.asarray(getattr(jnew, name)), rtol=1e-6)
    jmap = np.asarray(jund.build_rectify_map(jcam, H, W, jnew))
    tmap = tund.build_rectify_map(tcam, H, W, tnew)
    np.testing.assert_allclose(np_(tmap), jmap, atol=1e-4)
    frames = np.random.default_rng(7).random((3, H, W)).astype(np.float32) * 255
    jout = np.asarray(jund.remap_bilinear(jnp.asarray(frames), jnp.asarray(jmap)))
    np.testing.assert_allclose(
        np_(tund.remap_bilinear(torch.from_numpy(frames), to_torch(jmap))),
        jout, atol=1e-3)
    np.testing.assert_allclose(
        np_(tund.remap_bilinear(torch.from_numpy(frames), tmap)), jout,
        atol=1e-3)


def test_associate_sequential_matches_jax_on_lateral_drift():
    """The lateral drift of tests/test_streaming.py:54-77 (~3.4 px/frame,
    40+ px in all, beyond the 20 px gate): the same JAX detections through
    both; then the port in chunks with the carried last-seen positions."""
    d = np.zeros((16, 65, 3), np.float32)
    d[:, :, 0] = 0.3 * np.arange(16)[:, None]
    frames, _ = _render(None, d)
    jc = jcfg.PipelineConfig()
    jref = jpipe.initialize(to_jax(frames[0]), jc)
    from vision_basedsensor_tpu.detect import detect_markers
    jdet = detect_markers(to_jax(frames), jc.detect, axis_scale=jref.axis_scale)
    gate = jc.track.min_marker_distance_px
    jt = jassoc_seq(jref, jdet, gate)
    tref = convert.reference_from_numpy(jref, device="cpu")
    tdet = Detections(*(torch.from_numpy(np.array(np.asarray(
        x, np.float32 if x.dtype.kind == "f" else x.dtype))) for x in jdet))
    tt = tassoc_seq(tref, tdet, gate)
    np.testing.assert_array_equal(np_(tt.valid), np.asarray(jt.valid))
    assert np_(tt.valid)[-1].sum() >= 60
    np.testing.assert_allclose(np_(tt.xy), np.asarray(jt.xy), atol=1e-6)
    np.testing.assert_allclose(np_(tt.axes), np.asarray(jt.axes), atol=1e-6)

    carry, parts = None, []
    for i in range(0, 16, 5):
        chunk = Detections(*(x[i:i + 5] for x in tdet))
        part, carry = tassoc_seq(tref, chunk, gate, carry_xy=carry,
                                 return_carry=True)
        parts.append(part)
    np.testing.assert_array_equal(_cat(parts, lambda o: o.valid), np_(tt.valid))
    np.testing.assert_array_equal(_cat(parts, lambda o: o.xy), np_(tt.xy))


def test_carry_and_assoc_xy_cross_from_jax():
    """convert.carry_from_numpy / assoc_xy_from_numpy keep the schema."""
    from vision_basedsensor_tpu.reconstruct.displacement import \
        initial_carry as jinit

    carry = convert.carry_from_numpy(jinit(65), device="cpu")
    assert carry["last_ok"].dtype == torch.bool
    assert carry["last"].dtype == torch.float32
    assert tuple(carry["last"].shape) == (65, 3)
    xy = convert.assoc_xy_from_numpy(np.ones((65, 2)), device="cpu")
    assert xy.dtype == torch.float32 and tuple(xy.shape) == (65, 2)


def test_constructors_default_to_the_card(tmp_path):
    """Without a device argument every user-facing constructor builds on
    CUDA, and raises where there is no CUDA device."""
    from vision_basedsensor_tpu.reconstruct.displacement import \
        initial_carry as jinit

    from vision_basedsensor_tpu_torch.core.camera import CameraModel
    from vision_basedsensor_tpu_torch.reconstruct.displacement import \
        initial_carry
    from vision_basedsensor_tpu_torch.synth import default_scene

    cpu_cam = convert.camera_from_numpy(jscene(H, W).cam, device="cpu")
    tsession.save_session(str(tmp_path), convert.reference_from_numpy(
        jpipe.ReferenceMarkers(xy=np.zeros((65, 2)), axes=np.zeros((65, 2)),
                               angle=np.zeros(65), ring=np.zeros(65, np.int32),
                               valid=np.ones(65, bool), axis_scale=1.0),
        device="cpu"), jcfg.PipelineConfig())
    builders = {
        "default_scene": lambda: default_scene(H, W).cam.fx,
        "CameraModel.create": lambda: CameraModel.create(1, 1, 0, 0).fx,
        "camera_from_numpy": lambda: convert.camera_from_numpy(
            jscene(H, W).cam).fx,
        "carry_from_numpy": lambda: convert.carry_from_numpy(
            jinit(65))["last"],
        "initial_carry": lambda: initial_carry(65)["last"],
        "StreamingPipeline": lambda: tpipe.StreamingPipeline(
            cpu_cam, convert.config_from_jax(jcfg.PipelineConfig())).cam.fx,
        "load_session": lambda: tsession.load_session(str(tmp_path)).ref.xy,
    }
    for name, build in builders.items():
        if torch.cuda.is_available():
            assert build().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
