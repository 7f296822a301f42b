"""Multi-device pipeline: the frame batch, and each frame's rows, split
over devices.

Port of ``vision_basedsensor_tpu/parallel/mesh.py``. The pipeline's natural
parallel axis is the frame batch (``data``): detection is purely per frame.
The one sequential coupling is the last-sighting displacement scan (and, in
sequential mode, the association scan), whose state is a few floats per
marker. So, as in the reference, the pixel work runs sharded and the small
per-frame marker tables are gathered to one device, which runs
association, reconstruction, the scans and the contact state on the whole
batch in frame order. A ``(data, spatial)`` mesh also splits each frame's
rows over the devices of a data group (``spatial``, for one frame's
latency): the row shards detect together through a written-out halo
exchange (``parallel/spatial.py``), the reference's GSPMD halos.

The reference runs one SPMD program under ``shard_map`` and lets XLA insert
an all-gather. Here one process drives every device in turn (no
``torch.distributed``, no launcher): each shard's preprocess and detect is
issued on its own device, its CUDA kernels launching there
(``ops/cuda/build.py``), then its tables are copied to the mesh's first
device. Work issued to different cards overlaps as long as nothing in
detect waits for the device and no copy comes between two shards' work
(the step places every shard's inputs first; a row-sharded detect issues
each stage on every shard before the copies that follow it). A mesh may
name one device more than once: its shards then run in turn on that
device, which is how a one-card machine runs the sharding code
(``make_mesh(["cuda:0", "cuda:0"])``, or ``["cpu"] * n`` in the tests).
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
from vision_basedsensor_tpu_torch.parallel.spatial import (detect_row_shards,
                                                           row_plan)
from vision_basedsensor_tpu_torch.pipeline import (PipelineOutputs, _associate,
                                                   _preprocess, _to,
                                                   prepare_undistortion)
from vision_basedsensor_tpu_torch.reconstruct.depth import reconstruct_positions
from vision_basedsensor_tpu_torch.reconstruct.displacement import (
    displacement_scan, warmup_mask)
from vision_basedsensor_tpu_torch.track.rings import ReferenceMarkers

class Mesh(NamedTuple):
    """The devices of a mesh. ``("data",)``: shard ``i`` on ``devices[i]``.
    ``("data", "spatial")``: ``devices[i][j]`` holds rows block ``j`` of
    data group ``i``'s frames. The first device gathers the marker tables
    and runs the scans."""
    devices: tuple
    axis_names: tuple[str, ...] = ("data",)

    @property
    def spatial(self) -> int:
        """The number of row blocks a frame is split into (1: none)."""
        return len(self.devices[0]) if "spatial" in self.axis_names else 1

    @property
    def grid(self) -> tuple[tuple[torch.device, ...], ...]:
        """The devices as ``(data, spatial)`` rows (one column on a data
        mesh)."""
        if "spatial" in self.axis_names:
            return self.devices
        return tuple((d,) for d in self.devices)

    @property
    def home(self) -> torch.device:
        """The device that gathers the tables and runs the scans."""
        return self.grid[0][0]


class ShardedFrames(NamedTuple):
    """A frame batch split into equal contiguous blocks of frames (and,
    with ``spatial`` > 1, of rows): ``blocks[i * spatial + j]`` holds rows
    block ``j`` of data group ``i``'s frames on ``mesh.grid[i][j]``. The
    first ``n_frames`` frames are real, the rest (at the tail) zero
    padding."""
    blocks: tuple[torch.Tensor, ...]
    n_frames: int
    spatial: int = 1


def _device(d) -> torch.device:
    dev = resolve(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, spatial: int = 1) -> Mesh:
    """A ``data`` mesh over ``devices`` (default: every visible card; raises
    where there is none), or with ``spatial`` > 1 a ``(data, spatial)``
    mesh whose row ``i`` is ``devices[i * spatial:(i + 1) * spatial]``.
    Devices may repeat: their shards run in turn."""
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
    if spatial < 1 or len(devs) % spatial:
        raise ValueError(f"make_mesh: {len(devs)} devices do not divide into "
                         f"row blocks of spatial={spatial}")
    if spatial == 1:
        return Mesh(devs)
    return Mesh(tuple(devs[i:i + spatial]
                      for i in range(0, len(devs), spatial)),
                ("data", "spatial"))


def shard_frames(frames, mesh: Mesh, pad: bool = True) -> ShardedFrames:
    """Split a frame batch ``(B, H, W[, 3])`` (tensor or numpy) into one
    contiguous block per data group of ``mesh`` and, on a spatial mesh,
    each block into ``spatial`` row blocks (``H % spatial == 0``), each
    placed on its device.

    A batch that does not divide the data axis is zero-padded at the tail
    (``pad=True``; else it raises): zero frames produce no detections, and
    the step drops them before the scans. The padding is made on each
    block's device, so no device holds more than its block.
    """
    if not isinstance(frames, torch.Tensor):
        frames = np.asarray(frames)
    grid, s = mesh.grid, mesh.spatial
    n, d = frames.shape[0], len(grid)
    if n == 0:
        raise ValueError("shard_frames: empty batch")
    if n % d and not pad:
        raise ValueError(f"batch of {n} frames does not divide the data "
                         f"axis ({d}) and pad=False")
    h = frames.shape[1]
    if h % s:
        raise ValueError(f"{h} rows do not divide the spatial axis ({s})")
    per, hs = -(-n // d), h // s
    blocks = []
    for i, row in enumerate(grid):
        for j, dev in enumerate(row):
            block = frames[i * per:(i + 1) * per, j * hs:(j + 1) * hs]
            block = (block.to(dev).contiguous()
                     if isinstance(block, torch.Tensor)
                     else torch.tensor(np.ascontiguousarray(block), device=dev))
            if block.shape[0] < per:
                block = torch.cat([block, torch.zeros(
                    (per - block.shape[0],) + tuple(block.shape[1:]),
                    dtype=block.dtype, device=dev)])
            blocks.append(block)
    return ShardedFrames(tuple(blocks), n, s)


def make_sharded_pipeline(mesh: Mesh, cam: CameraModel, cfg: PipelineConfig,
                          crop: bool = False, apply_warmup: bool = False,
                          with_carry: bool = False):
    """Build the multi-device pipeline step for ``mesh``.

    Returns ``step(frames, ref) -> PipelineOutputs`` for a
    :class:`ShardedFrames` (or a batch, which it shards): each data shard's
    preprocess and detect on its device (on a spatial mesh, the row shards
    of each data group detect together, ``parallel/spatial.py``), then the
    per-frame detection tables gathered to ``mesh.home`` in frame order
    with the padding dropped, and there the association
    (``cfg.track.association_mode``), reconstruction, warm-up mask,
    displacement scan and contact state over the real frames. Outputs lie
    on ``mesh.home``.

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
    shard (row-major on a spatial mesh), the kernel launches (``ops/cuda``
    counters) of that shard's preprocess and detect; ``step.last_transfers``
    every copy between two shards, or a shard and ``mesh.home``, in the
    order issued, as ``{"name", "shard", "src", "dst", "bytes"}``: the
    reference's axis scale out to each data shard, the rectify map (or, on
    a spatial mesh, each row shard's rows of it) when first built for a
    shape, and the detection tables back. On a spatial mesh ``shard`` is
    ``(i, j)`` and ``"peer"`` the other shard: the halo rows in
    (``halo``), the area-mask sums and the frame's mean (``area_sum``,
    ``area_mean``), the ranked cells (``cells.*``), the merged peaks and
    cut geometry out (``peaks.xy``, ``geom.*``), the window sums back
    (``sums``). Placing the inputs (frames by :func:`shard_frames`;
    ``ref``, ``carry`` and ``assoc_xy`` onto ``mesh.home``) is not listed.
    """
    home = mesh.home
    grid, s = mesh.grid, mesh.spatial
    cam = _to(cam, home)
    sequential = cfg.track.association_mode == "sequential"
    prep_cache: dict = {}      # (H, W) -> (rectify map or None, recon camera)
    plan_cache: dict = {}      # (H, W) -> the spatial mesh's RowPlan
    map_on: dict = {}          # ((H, W), shard) -> the map on its device

    def _prep_for(hw):
        if hw not in prep_cache:
            if cfg.undistort_frames:
                prep_cache[hw] = prepare_undistortion(cam, hw[0], hw[1], cfg,
                                                      crop)
            else:
                prep_cache[hw] = (None, cam)
        return prep_cache[hw]

    def _record(transfers, x, dev, name, shard, **peer):
        transfers.append({"name": name, "shard": shard, "src": str(x.device),
                          "dst": str(dev), **peer,
                          "bytes": x.numel() * x.element_size()})
        return x.to(dev)

    def _detect_data(frames, ref, rectify_map, hw, transfers, launches):
        """Each data shard's preprocess and detect. Two passes: PyTorch
        orders a copy between two cards after all work already queued on
        both, so a copy from ``home`` issued after shard 0's detect would
        hold every later shard behind it. Inputs go out first."""
        inputs = []
        for i, dev in enumerate(mesh.devices):
            smap = None
            if rectify_map is not None:
                if (hw, dev) not in map_on:
                    map_on[hw, dev] = _record(transfers, rectify_map, dev,
                                              "rectify_map", i)
                smap = map_on[hw, dev]
            scale = ref.axis_scale
            if isinstance(scale, torch.Tensor):
                scale = _record(transfers, scale, dev, "ref.axis_scale", i)
            inputs.append((smap, scale))
        dets = []
        for block, (smap, scale) in zip(frames.blocks, inputs):
            before = launch_counts()
            x = _preprocess(block, cfg, crop, smap)
            dets.append(detect_markers(x, cfg.detect, axis_scale=scale))
            after = launch_counts()
            launches.append({k: after[k] - before[k] for k in after})
        return dets

    def _detect_spatial(frames, ref, rectify_map, hw, transfers, launches):
        """The row shards of every data group detect together; each
        group's tables lie on its first device."""
        if hw not in plan_cache:
            plan_cache[hw] = row_plan(hw[0], hw[1], s, cfg, crop,
                                      rectify_map)
        plan = plan_cache[hw]
        maps = [[None] * s for _ in grid]
        if rectify_map is not None:
            for i, row in enumerate(grid):
                for j, dev in enumerate(row):
                    if (hw, (i, j)) not in map_on:
                        a, b = plan.blocks[j].block
                        part = rectify_map[a:b]
                        map_on[hw, (i, j)] = (
                            part.contiguous() if (i, j) == (0, 0) else
                            _record(transfers, part, dev, "rectify_map",
                                    (i, j), peer=(0, 0)))
                    maps[i][j] = map_on[hw, (i, j)]
        scales = []
        for i, row in enumerate(grid):
            scale = ref.axis_scale
            if isinstance(scale, torch.Tensor):
                scale = _record(transfers, scale, row[0], "ref.axis_scale",
                                (i, 0), peer=(0, 0))
            scales.append(scale)

        def copy(x, dev, name, shard, peer):
            return _record(transfers, x, dev, name, shard, peer=peer)

        blocks = [frames.blocks[i * s:(i + 1) * s] for i in range(len(grid))]
        dets, per_shard = detect_row_shards(blocks, grid, hw[0] // s, plan,
                                            cfg, scales, maps, copy)
        launches.extend(per_shard)
        return dets

    def step(frames, ref: ReferenceMarkers, *rest, n_frames: int | None = None):
        if not isinstance(frames, ShardedFrames):
            frames = shard_frames(frames, mesh)
        devices = [d for row in grid for d in row]
        if frames.spatial != s or len(frames.blocks) != len(devices):
            raise ValueError(f"{len(frames.blocks)} blocks of spatial="
                             f"{frames.spatial} for a mesh of {len(grid)} x "
                             f"{s} devices")
        for i, (block, dev) in enumerate(zip(frames.blocks, devices)):
            if block.device != dev:
                raise ValueError(f"block {i} lies on {block.device}, its mesh "
                                 f"device is {dev}")
        carry = assoc_xy = None
        if with_carry:
            carry = _to(rest[0], home)
            if sequential:
                assoc_xy = _to(rest[1], home)
        ref = _to(ref, home)
        per, hs = frames.blocks[0].shape[:2]
        hw = (int(hs) * s, int(frames.blocks[0].shape[2]))
        rectify_map, recon_cam = _prep_for(hw)
        transfers: list = []
        launches: list = []
        detect = _detect_spatial if s > 1 else _detect_data
        group_dets = detect(frames, ref, rectify_map, hw, transfers, launches)
        # The tables come back after every shard's work is issued.
        dets = []
        for i, (d, row) in enumerate(zip(group_dets, grid)):
            real = max(0, min(per, frames.n_frames - i * per))
            shard = i if s == 1 else (i, 0)
            peer = {} if s == 1 else {"peer": (0, 0)}
            dets.append(Detections(*(
                None if v is None else
                _record(transfers, v[:real], home, f"detections.{k}", shard,
                        **peer)
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
