"""The port's default device: the card.

Every user-facing constructor (``default_scene``, ``CameraModel.create``,
``convert.*_from_numpy``, ``initial_carry``, ``StreamingPipeline``,
``load_session``) takes ``device=CUDA`` and builds its tensors there. Where
there is no CUDA device they raise; a caller that wants the CPU says
``device="cpu"``.
"""
from __future__ import annotations

import torch

CUDA = torch.device("cuda")


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vision_basedsensor_tpu_torch builds its tensors on the GPU by "
            "default and torch.cuda.is_available() is False; pass "
            "device='cpu' to run on the CPU")
    return dev
