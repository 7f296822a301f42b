"""The multi-device path on the card (``parallel/``): the data-parallel step
(``make_sharded_pipeline``, ``with_carry``, ``ShardedPackedFeed``) and the
row-sharded (spatial) meshes, each against one card's ``process_frames``
on the same frames.

A mesh takes every visible card in turn; on one card its shards run in
turn there, so the tests run on one card and over several alike. Every test
is ``cuda_only`` and skips without a GPU. The file imports no JAX
(``tests/torch_parity.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import (assert_detections_as_sets,  # noqa: F401
                          assert_recon_close, counted, cuda, render_drift,
                          render_jpegs)

from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                 ReconstructConfig,
                                                 TrackConfig)
from vision_basedsensor_tpu_torch.detect.detector import Detections
from vision_basedsensor_tpu_torch.ops import jpeg as tj
from vision_basedsensor_tpu_torch.parallel import (ShardedPackedFeed,
                                                   make_mesh,
                                                   make_sharded_pipeline,
                                                   shard_frames)
from vision_basedsensor_tpu_torch.pipeline import initialize, process_frames

pytestmark = pytest.mark.cuda_only

TRANSPORTS = ("tdelta", "split", "packed")
# The spatial meshes: (devices, spatial) as data x spatial.
SPATIAL = {"1x2": (2, 2), "2x2": (4, 2), "1x4": (4, 4)}
# A lens with barrel distortion (tests/test_undistort.py:88).
DIST = (-0.18, 0.05, 0.0, 0.0, 0.0)


def _devices(n):
    """``n`` mesh devices, the visible cards in turn."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def _data_mesh():
    """Every visible card, or two shards in turn on one card."""
    return make_mesh(_devices(max(2, torch.cuda.device_count())))


def _xla(cfg):
    """``cfg`` on the detector's unfused branch, a row shard's."""
    return dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, backend="xla"))


def test_sharded_step_matches_process_frames_on_the_card(cuda):
    """Each shard launches the fields and gather kernels and the two filter
    stencils once, the step one scan; the result equals one card's batch
    (seen equal, world and cum_path within 1e-4, detections as sets within
    1e-3 px, 65 of 65 markers); only the marker tables and the axis scale
    move between a shard's card and the gather card."""
    mesh = _data_mesh()
    n = len(mesh.devices)
    scene, frames = render_drift(cuda, 480, 640, 16)
    cfg = PipelineConfig()
    ref = initialize(frames[0], cfg)
    base = process_frames(frames, ref, scene.cam, cfg)
    step = make_sharded_pipeline(mesh, scene.cam, cfg)
    out, launches = counted(lambda: step(shard_frames(frames, mesh), ref),
                            mesh.devices)
    assert launches == {"fields": n, "gather": n, "filters": 2 * n,
                        "scan": 1}
    for c in step.last_shard_launches:
        assert {k: v for k, v in c.items() if v} == {"fields": 1, "gather": 1,
                                                     "filters": 2}
    assert_recon_close(out, base)
    assert_detections_as_sets(out.detections, base.detections, 1e-3)
    assert int(out.tracked.valid.sum(-1).min()) == 65
    names = {f"detections.{k}" for k in Detections._fields}
    assert {t["name"] for t in step.last_transfers} <= names | {
        "ref.axis_scale"}


def test_sharded_step_with_carry_on_the_card(cuda):
    """``with_carry`` in two chunks gives one batch's seen and cum_path
    (within 1e-4) and counts every frame."""
    from vision_basedsensor_tpu_torch.reconstruct.displacement import \
        initial_carry

    mesh = _data_mesh()
    scene, frames = render_drift(cuda, 480, 640, 16)
    cfg = PipelineConfig()
    ref = initialize(frames[0], cfg)
    base = process_frames(frames, ref, scene.cam, cfg)
    step = make_sharded_pipeline(mesh, scene.cam, cfg, with_carry=True)
    o1, carry = step(shard_frames(frames[:8], mesh), ref,
                     initial_carry(65, device=cuda))
    o2, _ = step(shard_frames(frames[8:], mesh), ref, carry)
    assert torch.equal(torch.cat([o1.recon.seen, o2.recon.seen]),
                       base.recon.seen)
    cum = torch.cat([o1.recon.cum_path, o2.recon.cum_path])
    assert float((cum - base.recon.cum_path).abs().max()) <= 1e-4
    assert step.frames_seen == 16


def test_sharded_sequential_association_on_the_card(cuda):
    """Distorted frames with the undistort preprocess and sequential
    association: the step launches the association kernel once beside the
    shards' kernels, and gives one card's batch (validity equal, seen
    equal, world and cum_path within 1e-4)."""
    from vision_basedsensor_tpu_torch.pipeline import prepare_undistortion

    mesh = _data_mesh()
    n = len(mesh.devices)
    scene, frames = render_drift(cuda, 480, 640, 32, dist=np.asarray(DIST))
    cfg = PipelineConfig(undistort_frames=True,
                         track=TrackConfig(association_mode="sequential"),
                         reconstruct=ReconstructConfig(warmup_frames=0))
    src_map, new_cam = prepare_undistortion(scene.cam, 480, 640, cfg)
    ref = initialize(frames[0], cfg, rectify_map=src_map)
    base = process_frames(frames, ref, new_cam, cfg, rectify_map=src_map)
    step = make_sharded_pipeline(mesh, scene.cam, cfg)
    out, launches = counted(lambda: step(shard_frames(frames, mesh), ref),
                            mesh.devices)
    assert launches == {"fields": n, "gather": n, "filters": 2 * n,
                        "scan": 1, "associate": 1}
    assert_recon_close(out, base)
    assert torch.equal(out.tracked.valid, base.tracked.valid)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_sharded_packed_feed_on_the_card(cuda, transport):
    """``ShardedPackedFeed`` decodes the same frames as one card, bit for
    bit, launching the expand kernel as often a shard as one decode call
    does."""
    mesh = _data_mesh()
    _, jpegs = render_jpegs(cuda, 16)
    dec = tj.MjpegBatchDecoder(device=cuda)
    single, k1 = counted(lambda: getattr(dec, f"{transport}_to_device")(
        getattr(dec, f"entropy_decode_{transport}")(jpegs)))
    feed = ShardedPackedFeed(mesh, transport=transport)
    sh, kn = counted(lambda: feed.decode_packed(jpegs), mesh.devices)
    assert kn == {"expand_sorted": len(mesh.devices) * k1["expand_sorted"]}
    assert torch.equal(torch.cat([x.to(cuda) for x in sh.blocks]), single)


def _spatial_mesh(name):
    n, s = SPATIAL[name]
    return make_mesh(_devices(n), spatial=s)


def _assert_spatial_step(mesh, scene, frames, ref, cfg, xcfg):
    """The step on ``mesh`` against one card's unfused batch: the
    window-sums kernel and the two filter stencils once a row shard, one
    scan; seen equal, world and cum_path within 1e-4, detections as sets
    within 1e-2 px, 65 of 65 markers."""
    devices = [d for row in mesh.grid for d in row]
    n_sh = len(devices)
    base = process_frames(frames, ref, scene.cam, xcfg)
    step = make_sharded_pipeline(mesh, scene.cam, cfg)
    out, launches = counted(lambda: step(shard_frames(frames, mesh), ref),
                            devices)
    assert launches == {"window_sums": n_sh, "filters": 2 * n_sh, "scan": 1}
    assert len(step.last_shard_launches) == n_sh
    for c in step.last_shard_launches:
        assert {k: v for k, v in c.items() if v} == {"window_sums": 1,
                                                     "filters": 2}
    assert_recon_close(out, base)
    assert_detections_as_sets(out.detections, base.detections, 1e-2)
    assert int(out.tracked.valid.sum(-1).min()) == 65


@pytest.mark.parametrize("mesh_name", list(SPATIAL))
def test_spatial_mesh_matches_process_frames_on_the_card(cuda, mesh_name):
    """Row-sharded 1080x1920 frames (the high-res profile's halo) on each
    mesh, and 640x480 frames where the mesh has two data groups, against
    one card's unfused batch; on a mesh of one data group, the row shards'
    detect makes no call that waits for the card."""
    from vision_basedsensor_tpu_torch.parallel import spatial as psp

    mesh = _spatial_mesh(mesh_name)
    cfg = PipelineConfig()
    xcfg = _xla(cfg)
    sizes = [(1080, 1920, 4)] + [(480, 640, 8)] * (len(mesh.grid) > 1)
    for h, w, b in sizes:
        scene, frames = render_drift(cuda, h, w, b)
        ref = initialize(frames[0], xcfg)
        _assert_spatial_step(mesh, scene, frames, ref, cfg, xcfg)
    if len(mesh.grid) > 1:
        return
    s = mesh.spatial
    plan = psp.row_plan(h, w, s, cfg, False)
    blocks = [shard_frames(frames, mesh).blocks]
    maps = [[None] * s]

    def detect():
        psp.detect_row_shards(blocks, mesh.grid, h // s, plan, cfg,
                              [ref.axis_scale], maps,
                              lambda x, d, *a: x.to(d))
    detect()
    for d in set(mesh.grid[0]):
        torch.cuda.synchronize(d)
    torch.cuda.set_sync_debug_mode("error")
    try:
        detect()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_spatial_packed_feed_on_the_card(cuda, transport):
    """On a 2 x 2 mesh ``ShardedPackedFeed`` decodes each data group's
    frames on its first device (the expand kernel as often a group as one
    decode call launches it) bit for bit as one card, and the step on the
    feed's blocks where they lie gives one card's unfused batch."""
    mesh = _spatial_mesh("2x2")
    devices = [d for row in mesh.grid for d in row]
    s = mesh.spatial
    scene, jpegs = render_jpegs(cuda, 16)
    dec = tj.MjpegBatchDecoder(device=cuda)
    single, k1 = counted(lambda: getattr(dec, f"{transport}_to_device")(
        getattr(dec, f"entropy_decode_{transport}")(jpegs)))
    feed = ShardedPackedFeed(mesh, transport=transport)
    sh, kn = counted(lambda: feed.decode_packed(jpegs), devices)
    assert kn == {"expand_sorted": len(mesh.grid) * k1["expand_sorted"]}
    got = torch.cat([torch.cat([b.to(cuda) for b in sh.blocks[i * s:
                                                               (i + 1) * s]],
                               1)
                     for i in range(len(mesh.grid))])
    assert torch.equal(got, single)

    cfg = PipelineConfig()
    xcfg = _xla(cfg)
    ref = initialize(single[0], xcfg)
    step = make_sharded_pipeline(mesh, scene.cam, cfg)
    out, launches = counted(lambda: step(sh, ref), devices)
    n_sh = len(devices)
    assert launches == {"window_sums": n_sh, "filters": 2 * n_sh, "scan": 1}
    assert_recon_close(out, process_frames(single, ref, scene.cam, xcfg))
