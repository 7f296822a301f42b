"""Data-parallel multi-device pipeline: the frame batch split over devices.

Port of ``vision_basedsensor_tpu/parallel/mesh.py``'s ``data`` axis. The
pipeline's natural parallel axis is the frame batch: detection is purely
per frame. The one sequential coupling is the last-sighting displacement
scan (and, in sequential mode, the association scan), whose state is a few
floats per marker. So, as in the reference, the pixel work runs sharded and
the small per-frame marker tables are gathered to one device, which runs
association, reconstruction, the scans and the contact state on the whole
batch in frame order.

The reference runs one SPMD program under ``shard_map`` and lets XLA insert
an all-gather. Here one process drives every device in turn (no
``torch.distributed``, no launcher): each shard's preprocess and detect is
issued on its own device, its CUDA kernels launching there
(``ops/cuda/build.py``), then its tables are copied to ``mesh.devices[0]``.
Work issued to different cards overlaps as long as nothing in detect waits
for the device and no copy from ``mesh.devices[0]`` comes between two
shards' work (the step places every shard's inputs first). A mesh may name
one device more than once: its shards then run in turn on that device,
which is how a one-card machine runs the sharding code
(``make_mesh(["cuda:0", "cuda:0"])``, or ``["cpu"] * n`` in the tests).

Not ported: the reference's ``spatial`` axis (image rows split over
devices, ``mesh.py:125-132,181-185``), whose filter halos GSPMD exchanges
there; here it would need a hand-written halo exchange through the whole
filter, peak and window stack (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vision_basedsensor_tpu_torch.analysis.force import contact_state_sequence
from vision_basedsensor_tpu_torch.config import PipelineConfig
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.core.device import resolve
from vision_basedsensor_tpu_torch.detect.detector import (Detections,
                                                          detect_markers)
from vision_basedsensor_tpu_torch.ops.cuda import launch_counts
from vision_basedsensor_tpu_torch.pipeline import (PipelineOutputs, _associate,
                                                   _preprocess, _to,
                                                   prepare_undistortion)
from vision_basedsensor_tpu_torch.reconstruct.depth import reconstruct_positions
from vision_basedsensor_tpu_torch.reconstruct.displacement import (
    displacement_scan, warmup_mask)
from vision_basedsensor_tpu_torch.track.rings import ReferenceMarkers

class Mesh(NamedTuple):
    """The devices of a data-parallel mesh, shard ``i`` on ``devices[i]``;
    ``devices[0]`` gathers the marker tables and runs the scans."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)


class ShardedFrames(NamedTuple):
    """A frame batch split into equal contiguous blocks, ``blocks[i]`` on
    ``mesh.devices[i]``; the first ``n_frames`` frames are real, the rest
    (at the tail) zero padding."""
    blocks: tuple[torch.Tensor, ...]
    n_frames: int


def _device(d) -> torch.device:
    dev = resolve(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, spatial: int = 1) -> Mesh:
    """A ``data`` mesh over ``devices`` (default: every visible card; raises
    where there is none). Devices may repeat: their shards run in turn."""
    if spatial > 1:
        raise NotImplementedError(
            "the spatial (row-sharded) mesh axis is not ported: it needs a "
            "halo exchange through the filter stack (ROADMAP.md, Queue 1)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every visible GPU and "
                "torch.cuda.is_available() is False; pass devices=['cpu'] "
                "* n for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(devs)


def shard_frames(frames, mesh: Mesh, pad: bool = True) -> ShardedFrames:
    """Split a frame batch ``(B, H, W[, 3])`` (tensor or numpy) into one
    contiguous block per device of ``mesh``, each placed on its device.

    A batch that does not divide the mesh is zero-padded at the tail
    (``pad=True``; else it raises): zero frames produce no detections, and
    the step drops them before the scans. The padding is made on each
    block's device, so no device holds more than its block.
    """
    if not isinstance(frames, torch.Tensor):
        frames = np.asarray(frames)
    n, d = frames.shape[0], len(mesh.devices)
    if n == 0:
        raise ValueError("shard_frames: empty batch")
    if n % d and not pad:
        raise ValueError(f"batch of {n} frames does not divide the data "
                         f"axis ({d}) and pad=False")
    per = -(-n // d)
    blocks = []
    for i, dev in enumerate(mesh.devices):
        block = frames[i * per:(i + 1) * per]
        block = (block.to(dev) if isinstance(block, torch.Tensor)
                 else torch.tensor(block, device=dev))
        if block.shape[0] < per:
            block = torch.cat([block, torch.zeros(
                (per - block.shape[0],) + tuple(block.shape[1:]),
                dtype=block.dtype, device=dev)])
        blocks.append(block)
    return ShardedFrames(tuple(blocks), n)


def make_sharded_pipeline(mesh: Mesh, cam: CameraModel, cfg: PipelineConfig,
                          crop: bool = False, apply_warmup: bool = False,
                          with_carry: bool = False):
    """Build the data-parallel pipeline step for ``mesh``.

    Returns ``step(frames, ref) -> PipelineOutputs`` for a
    :class:`ShardedFrames` (or a batch, which it shards): each shard's
    preprocess and detect on its device, then the per-frame detection
    tables gathered to ``mesh.devices[0]`` in frame order with the padding
    dropped, and there the association (``cfg.track.association_mode``),
    reconstruction, warm-up mask, displacement scan and contact state over
    the real frames. Outputs lie on ``mesh.devices[0]``.

    ``with_carry``: ``step(frames, ref, carry) -> (PipelineOutputs, carry)``
    carries the displacement-scan state across chunks (the
    ``initial_carry`` / session schema); in sequential association mode
    ``step(frames, ref, carry, assoc_xy) -> (out, (carry, assoc_xy))``.
    ``step.frames_seen`` counts real frames (``n_frames`` overrides the
    count) and gives the warm-up mask its global offset; a resumed session
    sets it. ``cfg.undistort_frames`` rectifies as the single-device
    pipeline does (map built once per frame shape; reconstruction on the
    rectified camera).

    Evidence of the last call: ``step.last_shard_launches`` holds, per
    shard, the kernel launches (``ops/cuda`` counters) of that shard's
    preprocess and detect; ``step.last_transfers`` every copy between a
    shard and ``mesh.devices[0]`` as ``{"name", "shard", "src", "dst",
    "bytes"}``: the reference's axis scale out to each shard, the rectify
    map when first built for a shape, and the detection tables back.
    Placing the inputs (frames by :func:`shard_frames`; ``ref``, ``carry``
    and ``assoc_xy`` onto ``mesh.devices[0]``) is not listed.
    """
    home = mesh.devices[0]
    cam = _to(cam, home)
    sequential = cfg.track.association_mode == "sequential"
    prep_cache: dict = {}      # (H, W) -> (rectify map or None, recon camera)
    map_on: dict = {}          # ((H, W), device) -> the map on that device

    def _prep_for(hw):
        if hw not in prep_cache:
            if cfg.undistort_frames:
                prep_cache[hw] = prepare_undistortion(cam, hw[0], hw[1], cfg,
                                                      crop)
            else:
                prep_cache[hw] = (None, cam)
        return prep_cache[hw]

    def _copy(x, dev, name, shard, src, dst, transfers):
        transfers.append({"name": name, "shard": shard, "src": str(src),
                          "dst": str(dst),
                          "bytes": x.numel() * x.element_size()})
        return x.to(dev)

    def step(frames, ref: ReferenceMarkers, *rest, n_frames: int | None = None):
        if not isinstance(frames, ShardedFrames):
            frames = shard_frames(frames, mesh)
        if len(frames.blocks) != len(mesh.devices):
            raise ValueError(f"{len(frames.blocks)} blocks for a mesh of "
                             f"{len(mesh.devices)} devices")
        carry = assoc_xy = None
        if with_carry:
            carry = _to(rest[0], home)
            if sequential:
                assoc_xy = _to(rest[1], home)
        ref = _to(ref, home)
        hw = tuple(int(s) for s in frames.blocks[0].shape[1:3])
        rectify_map, recon_cam = _prep_for(hw)
        transfers: list = []
        launches: list = []
        per = frames.blocks[0].shape[0]
        # Three passes: PyTorch orders a copy between two cards after all
        # work already queued on both, so a copy from ``home`` issued after
        # shard 0's detect would hold every later shard behind it. Inputs
        # go out first, then every shard's work, then the tables come back.
        inputs = []
        for i, (block, dev) in enumerate(zip(frames.blocks, mesh.devices)):
            if block.device != dev:
                raise ValueError(f"block {i} lies on {block.device}, its mesh "
                                 f"device is {dev}")
            smap = None
            if rectify_map is not None:
                if (hw, dev) not in map_on:
                    map_on[hw, dev] = _copy(rectify_map, dev, "rectify_map",
                                            i, home, dev, transfers)
                smap = map_on[hw, dev]
            scale = ref.axis_scale
            if isinstance(scale, torch.Tensor):
                scale = _copy(scale, dev, "ref.axis_scale", i, home, dev,
                              transfers)
            inputs.append((smap, scale))
        shard_dets = []
        for block, (smap, scale) in zip(frames.blocks, inputs):
            before = launch_counts()
            x = _preprocess(block, cfg, crop, smap)
            shard_dets.append(detect_markers(x, cfg.detect, axis_scale=scale))
            after = launch_counts()
            launches.append({k: after[k] - before[k] for k in after})
        dets = []
        for i, (d, dev) in enumerate(zip(shard_dets, mesh.devices)):
            real = max(0, min(per, frames.n_frames - i * per))
            dets.append(Detections(*(
                None if v is None else
                _copy(v[:real], home, f"detections.{k}", i, dev, home,
                      transfers)
                for k, v in zip(Detections._fields, d))))
        det = Detections(*(
            None if vals[0] is None else torch.cat(vals)
            for vals in zip(*dets)))

        tracked, assoc_out = _associate(ref, det, cfg, assoc_xy)
        world, ok = reconstruct_positions(recon_cam, tracked.xy, tracked.axes,
                                          tracked.valid, cfg.reconstruct)
        if apply_warmup:
            # The global frame index: a chunked session masks only the
            # first warmup_frames of the whole stream.
            offset = step.frames_seen if with_carry else 0
            world, ok = warmup_mask(world, ok, cfg.reconstruct.warmup_frames,
                                    offset)
        recon, carry_out = displacement_scan(world, ok, cfg.reconstruct,
                                             carry=carry, return_carry=True)
        out = PipelineOutputs(det, tracked, recon,
                              contact_state_sequence(recon, cfg.analysis))
        step.last_shard_launches = launches
        step.last_transfers = transfers
        if not with_carry:
            return out
        step.frames_seen += int(frames.n_frames if n_frames is None
                                else n_frames)
        return (out, (carry_out, assoc_out)) if sequential \
            else (out, carry_out)

    step.frames_seen = 0
    step.last_shard_launches = []
    step.last_transfers = []
    return step
