"""Sharded ingest: JPEG coefficient payloads decoded per data shard.

Port of ``vision_basedsensor_tpu/parallel/ingest.py``: the reference's one
transport is the MJPEG stream (``collecting.py:177-191``), so the sharded
counterpart of ``ops/jpeg.py``'s sparse transports splits a JPEG batch into
the mesh's contiguous frame slices. The host entropy-decodes each slice
into its own payload (frames are independent, so the split is exact); each
payload is copied to its shard's device, which expands and inverse-DCTs it
there (``ops/jpeg.py``: the sorted-expand kernel K8 launches on that
device). No device receives another shard's coefficients.

The reference pads every shard's streams to one length, because
``shard_map`` takes equal blocks; here each shard's payload is a tensor of
its own and keeps its own length.
"""
from __future__ import annotations

import torch

from vision_basedsensor_tpu_torch.ops.jpeg import (MjpegBatchDecoder,
                                                   delta_idct_frames,
                                                   split_idct_frames,
                                                   tdelta_idct_frames)
from vision_basedsensor_tpu_torch.parallel.mesh import Mesh, ShardedFrames


class ShardedPackedFeed:
    """Entropy-decode JPEG batches into per-shard payloads and decode each
    on its shard's device, giving :class:`ShardedFrames` that
    ``make_sharded_pipeline``'s step takes without moving them."""

    def __init__(self, mesh: Mesh, transport: str = "split"):
        """``transport``: ``split`` (default: DC/AC separated streams),
        ``tdelta`` (temporal coefficient deltas; each shard's slice is
        self-contained, its first frame shipping absolute) or ``packed``
        (2-byte delta pairs); see :class:`MjpegBatchDecoder`. Every
        coefficient is kept (the decoder's band limit stays at 64)."""
        if transport not in ("tdelta", "split", "packed"):
            raise ValueError(
                f"transport must be tdelta|split|packed, got {transport}")
        self.mesh = mesh
        self._dec = MjpegBatchDecoder(device=mesh.home)
        self._transport = transport

    @property
    def last_stats(self) -> dict | None:
        """The entropy decoder's stats of the last shard decoded."""
        return self._dec.last_stats

    def decode_packed(self, jpegs: list[bytes]) -> ShardedFrames:
        """Batch of same-geometry JPEGs -> (B, H, W) float32 frames in one
        block per mesh device (on a spatial mesh, one rows block per
        device; ``H`` must divide by ``spatial``). ``len(jpegs)`` must
        divide evenly by the data axis (batch at a multiple of it; pad the
        final short chunk)."""
        grid, s = self.mesh.grid, self.mesh.spatial
        d = len(grid)
        n = len(jpegs)
        if n % d != 0:
            raise ValueError(f"batch of {n} frames does not divide the data "
                             f"axis ({d}); pad the final chunk")
        per = n // d
        dec = getattr(self._dec, f"entropy_decode_{self._transport}")
        shards = [dec(jpegs[i * per:(i + 1) * per]) for i in range(d)]
        geo = {(s.height, s.width, s.grid) for s in shards}
        if len(geo) != 1:
            raise ValueError(f"geometry changed inside a batch: {geo}")
        h = shards[0].height
        if h % s:
            raise ValueError(f"{h} rows do not divide the spatial axis ({s})")
        hs = h // s
        blocks = []
        for p, row in zip(shards, grid):
            frames = self._expand(p, row[0])
            blocks.extend(frames[:, j * hs:(j + 1) * hs].to(dev).contiguous()
                          for j, dev in enumerate(row))
        return ShardedFrames(tuple(blocks), n, s)

    def _expand(self, p, dev: torch.device) -> torch.Tensor:
        """One shard's payload -> its frames, decoded on ``dev``."""
        def to(a):
            return torch.from_numpy(a).to(dev)

        geom = dict(height=p.height, width=p.width, grid=p.grid)
        if self._transport == "tdelta":
            return tdelta_idct_frames(to(p.ac), to(p.sgaps), to(p.sdeltas),
                                      to(p.qtables), zmax=p.zmax, **geom)
        if self._transport == "split":
            return split_idct_frames(to(p.ac), to(p.dc), to(p.sgaps),
                                     to(p.sdeltas), to(p.dgaps),
                                     to(p.ddeltas), to(p.qtables),
                                     zmax=p.zmax, **geom)
        return delta_idct_frames(to(p.gaps), to(p.vals), to(p.sgaps),
                                 to(p.sdeltas), to(p.qtables), **geom)
