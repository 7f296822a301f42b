"""Fixed-size window extraction around peak locations.

A frozen copy of the port's module of the same name, plain PyTorch only."""
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


def patch_coords(start_xy: torch.Tensor, patch: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Global pixel coordinate grids ``(..., K, P, P)`` for (x, y)."""
    r = torch.arange(patch, dtype=torch.float32, device=start_xy.device)
    gx = start_xy[..., 0, None, None] + r[None, :]
    gy = start_xy[..., 1, None, None] + r[:, None]
    shape = start_xy.shape[:-1] + (patch, patch)
    return gx.expand(shape), gy.expand(shape)
