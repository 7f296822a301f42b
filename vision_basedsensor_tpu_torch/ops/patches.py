"""Fixed-size window extraction around peak locations.

Port of ``vision_basedsensor_tpu/ops/patches.py`` (``extract_patches``,
``patch_coords``), batched over leading axes (frames ``B`` and peaks ``K``).
"""
from __future__ import annotations

import torch


def patch_origins(h: int, w: int, centers_xy: torch.Tensor,
                  patch: int) -> torch.Tensor:
    """Top-left corners ``(..., K, 2)`` int32 ``(cx, cy)`` of the ``patch``
    windows centred on ``centers_xy``: rounded half to even (as
    ``jnp.round``), then clamped inside the ``(h, w)`` frame."""
    if h < patch or w < patch:
        raise ValueError(f"frame {(h, w)} is smaller than the {patch}-px patch")
    half = patch // 2
    xy = torch.round(centers_xy).int()
    cx = torch.clamp(xy[..., 0] - half, 0, w - patch)
    cy = torch.clamp(xy[..., 1] - half, 0, h - patch)
    return torch.stack([cx, cy], dim=-1).int().contiguous()


def extract_patches(img: torch.Tensor, centers_xy: torch.Tensor, patch: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``patch x patch`` windows of ``img`` ``(..., H, W)`` centred on
    ``centers_xy`` ``(..., K, 2)`` (x, y), clamped inside the frame. Returns
    ``(patches (..., K, P, P), start_xy (..., K, 2) float32)``."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    start = patch_origins(h, w, centers_xy, patch).long()
    r = torch.arange(patch, device=img.device)
    ys = start[..., 1, None, None] + r[:, None]                 # (..., K, P, 1)
    xs = start[..., 0, None, None] + r[None, :]                 # (..., K, 1, P)
    flat = (ys * w + xs).flatten(len(lead))                     # (..., K*P*P)
    vals = torch.gather(img.reshape(*lead, h * w), -1, flat)
    return vals.reshape(start.shape[:-1] + (patch, patch)), start.float()


def patch_coords(start_xy: torch.Tensor, patch: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Global pixel coordinate grids ``(..., K, P, P)`` for (x, y)."""
    r = torch.arange(patch, dtype=torch.float32, device=start_xy.device)
    gx = start_xy[..., 0, None, None] + r[None, :]
    gy = start_xy[..., 1, None, None] + r[:, None]
    shape = start_xy.shape[:-1] + (patch, patch)
    return gx.expand(shape), gy.expand(shape)
