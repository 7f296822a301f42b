"""The PyTorch port's marker-to-pose path vs the JAX pipeline, end to end.

Rendered 240x384 staircase frames (JAX synth) go through JAX ``run_video``
with ``DetectConfig(backend="pallas")`` (the Pallas kernels in interpret
mode) and through the port's ``run_video`` on the CPU (the kernels' plain
versions). Tolerances are set from the observed agreement (see each
assertion); the NCC field differs in the last float32 bits (another
summation order in the filter matmuls), which reorders equal-score
candidate slots, so detections are compared as sets and the 65-id tables
slot by slot.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import np_, render_jax, staircase, to_jax, to_torch

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu import pipeline as jpipe
from vision_basedsensor_tpu.ops.dog import dog_area_mask as jdog

from vision_basedsensor_tpu_torch import convert
from vision_basedsensor_tpu_torch import pipeline as tpipe
from vision_basedsensor_tpu_torch.ops.cuda import fields as tfields
from vision_basedsensor_tpu_torch.ops.cuda import moments as tgather
from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask as tdog

H, W, B = 240, 384, 4


@pytest.fixture(scope="module")
def runs():
    frames, scene = render_jax(H, W, staircase(B, 0.3))
    jc = jcfg.PipelineConfig(
        detect=jcfg.DetectConfig(backend="pallas"),
        reconstruct=jcfg.ReconstructConfig(warmup_frames=0))
    tc = convert.config_from_jax(jc)
    jref = jpipe.initialize(to_jax(frames[0]), jc)
    jout = jax.block_until_ready(
        jpipe.process_frames(to_jax(frames), jref, scene.cam, jc))
    cam = convert.camera_from_numpy(scene.cam, device="cpu")
    f0, g0 = tfields.fields_launches, tgather.gather_launches
    tout = tpipe.run_video(to_torch(frames), cam, tc, apply_warmup=False)
    launches = (tfields.fields_launches - f0, tgather.gather_launches - g0)
    return dict(frames=frames, jc=jc, tc=tc, jref=jref, jout=jout, cam=cam,
                tout=tout, launches=launches)


def test_dog_mask_differing_pixels(runs):
    """The DoG mask rounds blurs computed by float32 matmuls; an exact .5
    may round the other way under another summation order. Observed: 0
    differing pixels of 4 x 240 x 384."""
    prof = runs["jc"].detect.low_res
    mj = np.asarray(jdog(jnp.asarray(runs["frames"]), prof, 15))
    mt = np_(tdog(to_torch(runs["frames"]), runs["tc"].detect.low_res, 15))
    assert (mj != mt).sum() <= 4


def test_reference_table_ids_and_valid_exact(runs):
    tt, jt = runs["tout"].tracked, runs["jout"].tracked
    np.testing.assert_array_equal(np.asarray(jt.ring), np_(tt.ring))
    np.testing.assert_array_equal(np.asarray(runs["jref"].valid),
                                  np_(tt.valid[0]))
    assert int(tt.valid[0].sum()) >= 60
    # Observed 1.5e-5 px.
    np.testing.assert_allclose(np.asarray(jt.ref_xy), np_(tt.ref_xy), atol=1e-3)


def test_detections_match_as_sets(runs):
    jd, td = runs["jout"].detections, runs["tout"].detections
    for b in range(B):
        jv, tv = np.asarray(jd.valid[b]), np_(td.valid[b])
        assert jv.sum() == tv.sum()
        jxy, txy = np.asarray(jd.xy[b])[jv], np_(td.xy[b])[tv]
        d = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
        nearest = d.argmin(1)
        assert len(set(nearest.tolist())) == len(nearest)
        # Observed 3e-5 px (axes 7e-4 px: the axis-scale median).
        assert d.min(1).max() <= 1e-3
        np.testing.assert_allclose(np.asarray(jd.axes[b])[jv],
                                   np_(td.axes[b])[tv][nearest], atol=2e-3)


def test_tracked_positions_and_axes(runs):
    jt, tt = runs["jout"].tracked, runs["tout"].tracked
    v = np.asarray(jt.valid)
    np.testing.assert_array_equal(v, np_(tt.valid))
    # Observed 3.1e-5 px (xy) and 5e-5 px (axes).
    np.testing.assert_allclose(np.asarray(jt.xy)[v], np_(tt.xy)[v], atol=1e-3)
    np.testing.assert_allclose(np.asarray(jt.axes)[v], np_(tt.axes)[v],
                               atol=1e-3)


def test_world_positions_and_tilt(runs):
    jr, tr = runs["jout"].recon, runs["tout"].recon
    np.testing.assert_array_equal(np.asarray(jr.seen), np_(tr.seen))
    # Observed 4e-5 mm (world) and 5e-5 mm (from_first).
    np.testing.assert_allclose(np.asarray(jr.world), np_(tr.world), atol=5e-4)
    np.testing.assert_allclose(np.asarray(jr.from_first), np_(tr.from_first),
                               atol=5e-4)
    # Observed 4.3e-5 deg.
    np.testing.assert_allclose(np.asarray(runs["jout"].contact.tilt_deg),
                               np_(runs["tout"].contact.tilt_deg), atol=5e-4)
    assert torch.isfinite(runs["tout"].contact.tilt_deg).all()


def test_converted_reference_reproduces_jax_tracking(runs):
    """The JAX frame-0 table carried across (convert.py) drives the port's
    process_frames to the same tracked set."""
    ref = convert.reference_from_numpy(runs["jref"], device="cpu")
    out = tpipe.process_frames(to_torch(runs["frames"]), ref, runs["cam"],
                               runs["tc"])
    jt = runs["jout"].tracked
    np.testing.assert_array_equal(np.asarray(jt.valid), np_(out.tracked.valid))
    v = np.asarray(jt.valid)
    np.testing.assert_allclose(np.asarray(jt.xy)[v], np_(out.tracked.xy)[v],
                               atol=1e-3)


def test_cpu_run_launches_no_kernel(runs):
    assert runs["launches"] == (0, 0)


@pytest.mark.parametrize("change", ["save_calibration", "load_calibration"])
def test_unported_options_raise(runs, change, tmp_path):
    """Options the port once lacked. Session calibration artifacts raised
    here until ``calibrate/artifact.py`` was ported; now a session saves a
    real artifact and loads it back, on a session written by the JAX
    package too (tests/test_torch_io_table.py holds the bytes). The bf16
    filters (``fast_filters``) raised until they were ported; they are held
    to JAX's in tests/test_torch_fast_filters.py."""
    from vision_basedsensor_tpu.calibrate import CalibrationArtifact as JArt
    from vision_basedsensor_tpu.io import session as jsession

    from vision_basedsensor_tpu_torch.calibrate import CalibrationArtifact
    from vision_basedsensor_tpu_torch.io import session

    art = dict(fx=600.5, fy=601.25, cx=192.0, cy=120.0, skew=0.0,
               dist=np.array([-0.18, 0.05, 0.001, -0.002, 0.0]),
               R_wc=np.eye(3), T_wc=np.array([0.0, 0.0, 40.0]))
    if change == "save_calibration":
        ref = convert.reference_from_numpy(runs["jref"], device="cpu")
        session.save_session(str(tmp_path), ref, runs["tc"],
                             calibration=CalibrationArtifact(**art))
        loaded = jsession.load_session(str(tmp_path)).calibration
    else:
        jsession.save_session(str(tmp_path), runs["jref"], runs["jc"],
                              calibration=JArt(**art))
        loaded = session.load_session(str(tmp_path),
                                      device="cpu").calibration
    assert (tmp_path / "calibration.json").exists()
    for name, want in art.items():
        np.testing.assert_array_equal(np.asarray(getattr(loaded, name)),
                                      want, name)
    cam = CalibrationArtifact(**art).to_camera(device="cpu")
    np.testing.assert_allclose(cam.dist.numpy(), art["dist"], rtol=1e-7)


def test_streaming_pipeline_not_ported(runs):
    """StreamingPipeline.run, once the unported part (it raised until the
    ingest's device_feed came): over a raw-frame source it yields the
    chunks that process() gives on the same frames. The JPEG ingest is in
    tests/test_torch_video.py."""
    from vision_basedsensor_tpu_torch.io.video import ArrayVideoSource

    frames = runs["frames"].astype(np.uint8)
    sp = tpipe.StreamingPipeline(runs["cam"], runs["tc"], device="cpu")
    outs = list(sp.run(ArrayVideoSource(frames), batch_size=3))
    assert [o.tracked.valid.shape[0] for o in outs] == [3, 1]
    assert sp.frames_seen == B
    ref = tpipe.StreamingPipeline(runs["cam"], runs["tc"], device="cpu")
    for o, i in zip(outs, (0, 3)):
        want = ref.process(torch.from_numpy(frames[i:i + 3]))
        assert torch.equal(o.tracked.valid, want.tracked.valid)
        assert torch.equal(o.tracked.xy, want.tracked.xy)
        assert torch.equal(o.recon.cum_path, want.recon.cum_path)


def test_initialize_rejects_blank_frame(runs):
    with pytest.raises(ValueError, match="no markers"):
        tpipe.initialize(torch.full((H, W), 190.0), runs["tc"])


@pytest.mark.parametrize("ring_method", ["layout_prior", "kmeans"])
def test_assign_identities_matches_jax_on_same_detections(runs, ring_method):
    """Identity assignment alone, on the JAX frame-0 detections carried
    across as numpy: ring labels and occupied slots exactly, for the default
    layout prior and for the KMeans alternative."""
    from vision_basedsensor_tpu.track.rings import assign_identities as jassign

    from vision_basedsensor_tpu_torch.detect.detector import Detections
    from vision_basedsensor_tpu_torch.track.rings import assign_identities

    jdet = type(runs["jout"].detections)(
        *(x[0] for x in runs["jout"].detections))
    tdet = Detections(*(torch.from_numpy(np.array(np.asarray(
        x, np.float32 if x.dtype.kind == "f" else x.dtype))) for x in jdet))
    jtc = dataclasses.replace(jcfg.TrackConfig(), ring_method=ring_method)
    jtc_full = jcfg.PipelineConfig(track=jtc)
    jr = jassign(jdet, jtc)
    tr = assign_identities(tdet, convert.config_from_jax(jtc_full).track)
    np.testing.assert_array_equal(np.asarray(jr.valid), np_(tr.valid))
    np.testing.assert_array_equal(np.asarray(jr.ring), np_(tr.ring))
    np.testing.assert_allclose(np.asarray(jr.xy), np_(tr.xy), atol=0)


@pytest.mark.parametrize("shape", [(2, 61, 77), (2, 61, 77, 3)])
def test_crop_frames_matches_jax(shape):
    """The pipeline's ``crop=True`` preprocess, gray and channel-last, with
    the default crop ratios: the same pixels."""
    from vision_basedsensor_tpu.core.imaging import crop_frames as jcrop

    from vision_basedsensor_tpu_torch.core.imaging import crop_frames as tcrop

    x = np.random.default_rng(5).random(shape).astype(np.float32)
    ratios = jcfg.PipelineConfig().crop_ratios
    np.testing.assert_array_equal(np.asarray(jcrop(jnp.asarray(x),
                                                   crop_ratios=ratios)),
                                  np_(tcrop(torch.from_numpy(x), ratios)))


def test_kmeans_1d_matches_jax_with_ties():
    from vision_basedsensor_tpu.track.rings import kmeans_1d as jk

    from vision_basedsensor_tpu_torch.track.rings import kmeans_1d as tk

    rng = np.random.default_rng(12)
    values = np.repeat(np.array([3.0, 7.0, 7.0, 12.0, 20.0, 31.0]), 5)
    values = (values + np.round(rng.normal(0, 0.5, values.shape), 1)).astype(np.float32)
    mask = rng.random(values.shape) > 0.1
    jc, jl = jk(jnp.asarray(values), jnp.asarray(mask), 5, 32)
    tc, tl = tk(torch.from_numpy(values), torch.from_numpy(mask), 5, 32)
    np.testing.assert_allclose(np.asarray(jc), np_(tc), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(jl), np_(tl))
