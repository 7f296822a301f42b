"""The port's data-parallel pipeline (parallel/) against single-device
process_frames of both packages, on CPU meshes.

A mesh of ``["cpu"] * n`` runs the sharding code with every shard on the
CPU. The frames are rendered by the JAX synth at 240x320 (B=8, the sizes of
tests/test_parallel.py) and go through the port's sharded step and through
JAX's single-device ``process_frames`` on the same reference table (JAX's
jitted sharded step is what its own tests mark slow on the CPU). The
sharded step must equal the port's single-device batch and agree with JAX
to the reference's tolerances (tests/test_parallel.py: world and cum_path
within 1e-4, ``seen`` equal).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import np_, to_jax

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu import pipeline as jpipe
from vision_basedsensor_tpu.synth import default_scene as jscene
from vision_basedsensor_tpu.synth import render_frames as jrender

from vision_basedsensor_tpu_torch import convert
from vision_basedsensor_tpu_torch import pipeline as tpipe
from vision_basedsensor_tpu_torch.io import session as tsession
from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
from vision_basedsensor_tpu_torch.ops.jpeg import MjpegBatchDecoder
from vision_basedsensor_tpu_torch.parallel import (ShardedFrames,
                                                   ShardedPackedFeed,
                                                   make_mesh,
                                                   make_sharded_pipeline,
                                                   shard_frames)
from vision_basedsensor_tpu_torch.reconstruct.displacement import \
    initial_carry

H, W, B = 240, 320, 8
DIST = np.array([-0.15, 0.04, 0.0006, -0.0004, 0.0])  # tests/test_parallel.py


def _render(n, step_mm, dist=None):
    scene = jscene(height=H, width=W, dist=dist)
    d = np.zeros((n, 65, 3), np.float32)
    d[:, :, 2] = -step_mm * np.arange(n)[:, None]
    return np.asarray(jrender(scene, jnp.asarray(d)), np.float32), scene


def _jax_run(frames, scene, jc, apply_warmup=False, rectify=False):
    """JAX's single-device batch: (reference table, outputs)."""
    x = to_jax(frames)
    rmap, cam = None, scene.cam
    if rectify:
        rmap, cam = jpipe.prepare_undistortion(scene.cam, H, W, jc, False)
    ref = jpipe.initialize(x[0], jc, False, rmap)
    out = jpipe.process_frames(x, ref, cam, jc, apply_warmup=apply_warmup,
                               rectify_map=rmap)
    return ref, jax.block_until_ready(out)


@pytest.fixture(scope="module")
def setup():
    frames, scene = _render(B, 0.1)
    jc = jcfg.PipelineConfig(reconstruct=jcfg.ReconstructConfig(warmup_frames=0))
    jref, jout = _jax_run(frames, scene, jc)
    return dict(frames=frames, scene=scene, jc=jc, jout=jout,
                tc=convert.config_from_jax(jc),
                cam=convert.camera_from_numpy(scene.cam, device="cpu"),
                ref=convert.reference_from_numpy(jref, device="cpu"))


@pytest.fixture(scope="module")
def sequential(setup):
    jc = dataclasses.replace(
        setup["jc"], track=jcfg.TrackConfig(association_mode="sequential"))
    jref, jout = _jax_run(setup["frames"], setup["scene"], jc)
    return dict(jc=jc, tc=convert.config_from_jax(jc), jout=jout,
                ref=convert.reference_from_numpy(jref, device="cpu"))


def _close(out, want, b=B):
    """world and cum_path within 1e-4, seen equal (tests/test_parallel.py)."""
    assert out.recon.world.shape[0] == b
    np.testing.assert_array_equal(np_(out.recon.seen), np_(want.recon.seen))
    np.testing.assert_allclose(np_(out.recon.world), np_(want.recon.world),
                               atol=1e-4)
    np.testing.assert_allclose(np_(out.recon.cum_path),
                               np_(want.recon.cum_path), atol=1e-4)


def _same_detections(out, want):
    """The gathered tables equal the single-device batch's, as sets per
    frame (equal scores may order slots differently)."""
    def rows(det, f):
        xy = np_(det.xy[f][det.valid[f]])
        return xy[np.lexsort((xy[:, 1], np.round(xy[:, 0], 2)))]

    for f in range(want.detections.xy.shape[0]):
        np.testing.assert_allclose(rows(out.detections, f),
                                   rows(want.detections, f), atol=1e-4)


def test_setup_actually_detects(setup):
    """The small scene gives real detections (tests/test_parallel.py:31-35's
    bar), so the comparisons below are not vacuous."""
    assert int(setup["ref"].valid.sum()) >= 60
    assert int(np_(setup["jout"].tracked.valid).sum(-1).min()) >= 60


@pytest.mark.parametrize("ndev", [2, 3, 5])
def test_sharded_step_matches_single_device(setup, ndev):
    """Uneven batches are zero-padded at the tail; the padding is dropped
    before the scans and detects nothing."""
    s = setup
    mesh = make_mesh(["cpu"] * ndev)
    sharded = shard_frames(s["frames"], mesh)
    per = -(-B // ndev)
    assert [b.shape[0] for b in sharded.blocks] == [per] * ndev
    assert sharded.n_frames == B
    pad = torch.cat(sharded.blocks)[B:]
    assert pad.numel() == 0 or not bool(pad.any())
    step = make_sharded_pipeline(mesh, s["cam"], s["tc"])
    out = step(sharded, s["ref"])
    base = tpipe.process_frames(torch.tensor(s["frames"]), s["ref"],
                                s["cam"], s["tc"])
    _close(out, base)
    _close(out, s["jout"])
    _same_detections(out, base)
    # Zero frames detect nothing, through the same detector.
    zero = tpipe.process_frames(torch.zeros((1, H, W)), s["ref"], s["cam"],
                                s["tc"])
    assert not bool(zero.detections.valid.any())
    # Evidence: one launch record per shard (the CPU takes the kernels'
    # plain versions, so every count is 0), and the only copies between a
    # shard and the gather device are the marker tables.
    assert len(step.last_shard_launches) == ndev
    assert all(set(c.values()) == {0} for c in step.last_shard_launches)
    names = {t["name"] for t in step.last_transfers}
    assert names == {"ref.axis_scale"} | {
        f"detections.{k}" for k, v in zip(out.detections._fields,
                                          out.detections) if v is not None}
    # Every shard's input goes out before any table comes back: a copy from
    # the gather device queued after shard 0's work would hold the later
    # shards behind it on the cards.
    back = [t["name"].startswith("detections.") for t in step.last_transfers]
    assert back == sorted(back) and not back[0]
    frame_bytes = H * W * 4
    assert all(t["bytes"] < frame_bytes for t in step.last_transfers)
    gathered = sum(t["bytes"] for t in step.last_transfers
                   if t["name"].startswith("detections."))
    assert gathered == sum(v.numel() * v.element_size()
                           for v in out.detections if v is not None)


def test_step_shards_an_unsharded_batch(setup):
    s = setup
    mesh = make_mesh(["cpu"] * 3)
    out = make_sharded_pipeline(mesh, s["cam"], s["tc"])(
        torch.tensor(s["frames"]), s["ref"])
    _close(out, s["jout"])


def test_sharded_checkpoint_resume(setup, tmp_path):
    """Two carried chunks, through a session save/load at the boundary,
    equal one batch (tests/test_parallel.py:111-132)."""
    s = setup
    mesh = make_mesh(["cpu"] * 4)
    step = make_sharded_pipeline(mesh, s["cam"], s["tc"], with_carry=True)
    out1, carry = step(shard_frames(s["frames"][:4], mesh), s["ref"],
                       initial_carry(65, device="cpu"))
    tsession.save_session(str(tmp_path / "sess"), s["ref"], s["tc"],
                          scan_carry=carry, frames_seen=step.frames_seen)
    sess = tsession.load_session(str(tmp_path / "sess"), device="cpu")
    step2 = make_sharded_pipeline(mesh, s["cam"], s["tc"], with_carry=True)
    step2.frames_seen = sess.frames_seen
    out2, _ = step2(shard_frames(s["frames"][4:], mesh), sess.ref,
                    sess.scan_carry)
    cum = np.concatenate([np_(out1.recon.cum_path), np_(out2.recon.cum_path)])
    np.testing.assert_allclose(cum, np_(s["jout"].recon.cum_path), atol=1e-4)
    assert step2.frames_seen == B


def test_sharded_sequential_association(setup, sequential):
    """The last-sighting association runs on the gathered tables in global
    frame order: one batch, and two carried chunks (assoc_xy carried)."""
    s, q = setup, sequential
    mesh = make_mesh(["cpu"] * 3)
    out = make_sharded_pipeline(mesh, s["cam"], q["tc"])(
        shard_frames(s["frames"], mesh), q["ref"])
    base = tpipe.process_frames(torch.tensor(s["frames"]), q["ref"],
                                s["cam"], q["tc"])
    _close(out, base)
    _close(out, q["jout"])
    step = make_sharded_pipeline(mesh, s["cam"], q["tc"], with_carry=True)
    carry, xy = initial_carry(65, device="cpu"), q["ref"].xy
    outs = []
    for i in (0, 5):
        o, (carry, xy) = step(shard_frames(s["frames"][i:i + 5], mesh),
                              q["ref"], carry, xy)
        outs.append(o)
    np.testing.assert_array_equal(
        np.concatenate([np_(o.tracked.valid) for o in outs]),
        np_(q["jout"].tracked.valid))
    np.testing.assert_allclose(
        np.concatenate([np_(o.recon.cum_path) for o in outs]),
        np_(q["jout"].recon.cum_path), atol=1e-4)
    assert step.frames_seen == B


def test_sharded_undistort(setup):
    """cfg.undistort_frames: the rectify map once per frame shape, the
    rectified camera for the reconstruction (tests/test_parallel.py:222)."""
    frames, scene = _render(4, 0.2, dist=DIST)
    jc = dataclasses.replace(setup["jc"], undistort_frames=True)
    jref, jout = _jax_run(frames, scene, jc, rectify=True)
    tc = convert.config_from_jax(jc)
    cam = convert.camera_from_numpy(scene.cam, device="cpu")
    ref = convert.reference_from_numpy(jref, device="cpu")
    mesh = make_mesh(["cpu"] * 3)
    step = make_sharded_pipeline(mesh, cam, tc)
    out = step(shard_frames(frames, mesh), ref)
    _close(out, jout, b=4)
    # Copied once to each distinct device of the mesh: here the CPU.
    assert [t["shard"] for t in step.last_transfers
            if t["name"] == "rectify_map"] == [0]
    step(shard_frames(frames, mesh), ref)   # the map is not copied again
    assert "rectify_map" not in {t["name"] for t in step.last_transfers}


def test_sharded_chunked_warmup_uses_global_offset(setup):
    """warmup_frames=2 over two carried chunks masks global frames 0-1
    only, and a padded chunk counts its real frames
    (tests/test_parallel.py:301-325)."""
    s = setup
    jc = dataclasses.replace(
        s["jc"], reconstruct=jcfg.ReconstructConfig(warmup_frames=2))
    _, jout = _jax_run(s["frames"], s["scene"], jc, apply_warmup=True)
    tc = convert.config_from_jax(jc)
    mesh = make_mesh(["cpu"] * 3)
    step = make_sharded_pipeline(mesh, s["cam"], tc, apply_warmup=True,
                                 with_carry=True)
    carry, seen = initial_carry(65, device="cpu"), []
    for i in range(0, B, 4):
        out, carry = step(shard_frames(s["frames"][i:i + 4], mesh), s["ref"],
                          carry)
        seen.append(np_(out.recon.seen))
    seen = np.concatenate(seen)
    np.testing.assert_array_equal(seen, np_(jout.recon.seen))
    assert not seen[:2].any() and seen[2:].sum() > 0
    assert step.frames_seen == B
    step(shard_frames(s["frames"][:4], mesh), s["ref"], carry, n_frames=1)
    assert step.frames_seen == B + 1


@pytest.fixture(scope="module")
def jpegs(setup):
    return [encode_jpeg(f, 70) for f in setup["frames"].astype(np.uint8)]


@pytest.mark.parametrize("transport", ["tdelta", "split", "packed"])
def test_sharded_packed_feed_matches_single_device(setup, jpegs, transport):
    """Each shard's payload decodes on its device to the single-device
    decode's frames bit for bit, and drives the sharded step."""
    s = setup
    mesh = make_mesh(["cpu"] * 4)
    feed = ShardedPackedFeed(mesh, transport=transport)
    sharded = feed.decode_packed(jpegs)
    assert isinstance(sharded, ShardedFrames) and sharded.n_frames == B
    assert [b.shape for b in sharded.blocks] == [(2, H, W)] * 4
    dec = MjpegBatchDecoder(device="cpu")
    single = getattr(dec, f"{transport}_to_device")(
        getattr(dec, f"entropy_decode_{transport}")(jpegs))
    assert torch.equal(torch.cat(sharded.blocks), single)
    assert feed.last_stats["frames"] == 2
    ref = tpipe.initialize(single[0], s["tc"])
    out = make_sharded_pipeline(mesh, s["cam"], s["tc"])(sharded, ref)
    base = tpipe.process_frames(single, ref, s["cam"], s["tc"])
    _close(out, base)


def test_sharded_packed_feed_rejects_bad_input():
    mesh = make_mesh(["cpu"] * 4)
    feed = ShardedPackedFeed(mesh)
    with pytest.raises(ValueError, match="divide"):
        feed.decode_packed([b"\xff\xd8"] * 5)
    with pytest.raises(ValueError, match="transport"):
        ShardedPackedFeed(mesh, transport="dense")


def test_mesh_arguments(setup, monkeypatch):
    grid = make_mesh(["cpu"] * 6, spatial=2)
    assert grid.axis_names == ("data", "spatial")
    assert grid.devices == ((torch.device("cpu"),) * 2,) * 3
    assert (grid.spatial, len(grid.grid)) == (2, 3)
    with pytest.raises(ValueError, match="divide"):
        make_mesh(["cpu"] * 5, spatial=2)
    with pytest.raises(ValueError, match="spatial axis"):
        shard_frames(np.zeros((2, 250, 8), np.float32),
                     make_mesh(["cpu"] * 4, spatial=4))
    mesh = make_mesh(["cpu", torch.device("cpu")])
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.axis_names == ("data",)
    with pytest.raises(ValueError, match="pad=False"):
        shard_frames(setup["frames"][:5], mesh, pad=False)
    with pytest.raises(ValueError, match="empty"):
        shard_frames(setup["frames"][:0], mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(["cuda:0"])


def test_launch_counts_read_and_reset_every_kernel(monkeypatch):
    from vision_basedsensor_tpu_torch.ops import cuda as kcuda
    from vision_basedsensor_tpu_torch.ops.cuda import fields, scan
    monkeypatch.setattr(fields, "fields_launches", 3)
    monkeypatch.setattr(scan, "assoc_launches", 2)
    counts = kcuda.launch_counts()
    assert set(counts) == set(kcuda.COUNTERS)
    assert counts["fields"] == 3 and counts["associate"] == 2
    kcuda.reset_launch_counts()
    assert set(kcuda.launch_counts().values()) == {0}


# -- the spatial (row-sharded) axis -------------------------------------------

# The order in which a row-sharded step issues its copies: each stage on
# every shard before the copies that follow it.
STAGES = (("rectify_map",), ("ref.axis_scale",), ("halo",), ("area_sum",),
          ("area_mean",), ("cells",), ("peaks", "geom"), ("sums",),
          ("detections",))


def _stage(name):
    for i, stage in enumerate(STAGES):
        if name.split(".")[0] in stage or name in stage:
            return i
    raise AssertionError(f"unexpected transfer {name}")


def _xla(tc):
    return dataclasses.replace(
        tc, detect=dataclasses.replace(tc.detect, backend="xla"))


def _check_spatial_evidence(step, mesh):
    """One launch record per row shard; halo rows only from shards of the
    same data group; every stage's copies in order, so that a shard's
    inputs are out before any result comes back."""
    groups, s = len(mesh.grid), mesh.spatial
    assert len(step.last_shard_launches) == groups * s
    assert all(set(c.values()) == {0} for c in step.last_shard_launches)
    stages = [_stage(t["name"]) for t in step.last_transfers]
    assert stages == sorted(stages)
    halo = [t for t in step.last_transfers if t["name"] == "halo"]
    assert halo and all(t["peer"][0] == t["shard"][0]
                        and t["peer"][1] != t["shard"][1] for t in halo)
    # Each shard receives halo rows from every neighbour its block reaches.
    assert {t["shard"] for t in halo} == {(i, j) for i in range(groups)
                                          for j in range(s)}


@pytest.mark.parametrize("ndev,spatial", [(8, 2), (8, 4), (6, 2)])
def test_spatial_step_matches_single_device(setup, ndev, spatial):
    """The reference's test_2d_mesh_data_spatial / _spatial4
    (tests/test_parallel.py:63-108), and an uneven batch on a data axis of
    3: the row shards' detections equal the single-device unfused branch."""
    s = setup
    mesh = make_mesh(["cpu"] * ndev, spatial=spatial)
    sharded = shard_frames(s["frames"], mesh)
    groups = ndev // spatial
    per = -(-B // groups)
    assert sharded.spatial == spatial
    assert [b.shape for b in sharded.blocks] \
        == [(per, H // spatial, W)] * ndev
    step = make_sharded_pipeline(mesh, s["cam"], s["tc"])
    out = step(sharded, s["ref"])
    base = tpipe.process_frames(torch.tensor(s["frames"]), s["ref"],
                                s["cam"], _xla(s["tc"]))
    _close(out, base)
    _close(out, s["jout"])
    _same_detections(out, base)
    _check_spatial_evidence(step, mesh)


def test_spatial_step_with_carry_and_sequential(setup, sequential):
    """Two carried chunks, and the last-sighting association over two
    carried chunks, on a (2, 4) mesh."""
    s, q = setup, sequential
    mesh = make_mesh(["cpu"] * 8, spatial=4)
    step = make_sharded_pipeline(mesh, s["cam"], s["tc"], with_carry=True)
    carry, cum = initial_carry(65, device="cpu"), []
    for i in (0, 4):
        out, carry = step(shard_frames(s["frames"][i:i + 4], mesh), s["ref"],
                          carry)
        cum.append(np_(out.recon.cum_path))
    np.testing.assert_allclose(np.concatenate(cum),
                               np_(s["jout"].recon.cum_path), atol=1e-4)
    assert step.frames_seen == B
    step = make_sharded_pipeline(make_mesh(["cpu"] * 4, spatial=2), s["cam"],
                                 q["tc"], with_carry=True)
    carry, xy = initial_carry(65, device="cpu"), q["ref"].xy
    outs = []
    for i in (0, 5):
        o, (carry, xy) = step(torch.tensor(s["frames"][i:i + 5]), q["ref"],
                              carry, xy)
        outs.append(o)
    base = tpipe.process_frames(torch.tensor(s["frames"]), q["ref"],
                                s["cam"], _xla(q["tc"]))
    for name in ("seen", "world", "cum_path"):
        np.testing.assert_allclose(
            np.concatenate([np_(getattr(o.recon, name)) for o in outs]),
            np_(getattr(base.recon, name)), atol=1e-4)
        np.testing.assert_allclose(
            np.concatenate([np_(getattr(o.recon, name)) for o in outs]),
            np_(getattr(q["jout"].recon, name)), atol=1e-4)
    np.testing.assert_array_equal(
        np.concatenate([np_(o.tracked.valid) for o in outs]),
        np_(q["jout"].tracked.valid))


def test_spatial_undistort(setup):
    """cfg.undistort_frames on a (2, 2) mesh: each row shard remaps from the
    source rows of its map rows, clamped to the frame's height; each
    shard's rows of the map are copied once."""
    frames, scene = _render(4, 0.2, dist=DIST)
    jc = dataclasses.replace(setup["jc"], undistort_frames=True)
    jref, jout = _jax_run(frames, scene, jc, rectify=True)
    tc = convert.config_from_jax(jc)
    cam = convert.camera_from_numpy(scene.cam, device="cpu")
    ref = convert.reference_from_numpy(jref, device="cpu")
    mesh = make_mesh(["cpu"] * 4, spatial=2)
    step = make_sharded_pipeline(mesh, cam, tc)
    out = step(shard_frames(frames, mesh), ref)
    _close(out, jout, b=4)
    rmap, rcam = tpipe.prepare_undistortion(cam, H, W, tc)
    base = tpipe.process_frames(torch.tensor(frames), ref, rcam, _xla(tc),
                                rectify_map=rmap)
    _close(out, base, b=4)
    _same_detections(out, base)
    assert sorted(t["shard"] for t in step.last_transfers
                  if t["name"] == "rectify_map") == [(0, 1), (1, 0), (1, 1)]
    step(shard_frames(frames, mesh), ref)
    assert "rectify_map" not in {t["name"] for t in step.last_transfers}
    _check_spatial_evidence(step, mesh)


def test_spatial_crop(setup):
    """crop=True with crop_ratios set: the shards read the raw rows below
    the crop's top and split the cropped frame's rows."""
    s = setup
    jc = dataclasses.replace(s["jc"], crop_ratios=(0.05, 0.1, 0.1, 0.05))
    x = to_jax(s["frames"])
    jref = jpipe.initialize(x[0], jc, True)
    jout = jax.block_until_ready(
        jpipe.process_frames(x, jref, s["scene"].cam, jc, crop=True))
    tc = convert.config_from_jax(jc)
    ref = convert.reference_from_numpy(jref, device="cpu")
    base = tpipe.process_frames(torch.tensor(s["frames"]), ref, s["cam"],
                                _xla(tc), crop=True)
    for spatial in (2, 4):
        mesh = make_mesh(["cpu"] * 8, spatial=spatial)
        step = make_sharded_pipeline(mesh, s["cam"], tc, crop=True)
        out = step(shard_frames(s["frames"], mesh), ref)
        _close(out, base)
        _close(out, jout)
        _same_detections(out, base)


@pytest.mark.parametrize("transport", ["tdelta", "split", "packed"])
def test_spatial_packed_feed_matches_single_device(setup, jpegs, transport):
    """The 2-D ShardedPackedFeed: each data group's payload decoded on its
    first device (one expand per group), its row blocks on the group's
    devices, bitwise equal to the single-device decode (the reference's
    test_sharded_packed_ingest_2d_mesh)."""
    s = setup
    mesh = make_mesh(["cpu"] * 8, spatial=2)
    sharded = ShardedPackedFeed(mesh, transport=transport).decode_packed(jpegs)
    assert sharded.spatial == 2 and sharded.n_frames == B
    assert [b.shape for b in sharded.blocks] == [(2, H // 2, W)] * 8
    dec = MjpegBatchDecoder(device="cpu")
    single = getattr(dec, f"{transport}_to_device")(
        getattr(dec, f"entropy_decode_{transport}")(jpegs))
    groups = [torch.cat(sharded.blocks[i:i + 2], 1) for i in range(0, 8, 2)]
    assert torch.equal(torch.cat(groups), single)
    if transport == "split":
        ref = tpipe.initialize(single[0], s["tc"])
        out = make_sharded_pipeline(mesh, s["cam"], s["tc"])(sharded, ref)
        _close(out, tpipe.process_frames(single, ref, s["cam"],
                                         _xla(s["tc"])))
    with pytest.raises(ValueError, match="spatial axis"):
        ShardedPackedFeed(make_mesh(["cpu"] * 7, spatial=7),
                          transport=transport).decode_packed(jpegs[:1])


def test_halo_rows_hand_count():
    """blur + NCC + max(band, peak) window halves + window half + 7 rows of
    a cell across the cut (the low-res profile: 17 + 16 + 4 + 20 + 7; the
    high-res: 50 + 40 + 7 + 32 + 7)."""
    from vision_basedsensor_tpu_torch.config import DetectConfig
    from vision_basedsensor_tpu_torch.parallel.spatial import halo_rows
    cfg = DetectConfig()
    assert halo_rows(cfg, cfg.low_res) == 64
    assert halo_rows(cfg, cfg.high_res) == 136


@pytest.mark.parametrize("spatial", [2, 4])
def test_row_block_fields_equal_the_frame(setup, spatial):
    """A shard's own rows of the DoG area mask equal the whole frame's
    exactly, and of the NCC (with the frame's mean) within 1e-5, with a
    marker across every cut."""
    from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask
    from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian
    from vision_basedsensor_tpu_torch.parallel.spatial import row_plan
    tc = setup["tc"]
    prof = tc.detect.low_res
    gray = torch.tensor(setup["frames"][:2])
    area = dog_area_mask(gray, prof, tc.detect.dog_offset).float()
    ncc = normxcorr_gaussian(area, prof.template_size, prof.template_sigma,
                             binary_input=True)
    mean = area.mean(dim=(-2, -1), keepdim=True)
    plan = row_plan(H, W, spatial, tc, False)
    assert plan.profile == prof and plan.halo == 64
    for blk in plan.blocks[1:]:
        cut = blk.own[0]
        assert bool(area[:, cut - 3:cut + 3].any(-1).all())   # a marker
    for blk in plan.blocks:
        (a, b), (o0, o1) = blk.block, blk.own
        assert a % 8 == 0 and blk.src == blk.block
        part = dog_area_mask(gray[:, a:b], prof, tc.detect.dog_offset).float()
        assert torch.equal(part[:, o0 - a:o1 - a], area[:, o0:o1])
        pncc = normxcorr_gaussian(part, prof.template_size,
                                  prof.template_sigma, binary_input=True,
                                  mean=mean)
        np.testing.assert_allclose(np_(pncc[:, o0 - a:o1 - a]),
                                   np_(ncc[:, o0:o1]), atol=1e-5)
