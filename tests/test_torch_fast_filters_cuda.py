"""``DetectConfig(fast_filters=True)`` on the card: the DoG and NCC filter
GEMMs in bfloat16 with float32 accumulation through the whole main path,
against the float32 filters on the same frames.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``); the GEMMs' own passes are held to their
CPU version by ``tests/test_torch_cuda.py:test_sep_filter_bf16_on_the_card``.
"""
import dataclasses
import math

import pytest
import torch

from torch_parity import counted, cuda, render_drift  # noqa: F401

from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                 ReconstructConfig)
from vision_basedsensor_tpu_torch.pipeline import initialize, process_frames

pytestmark = pytest.mark.cuda_only


def test_fast_filters_main_path_on_the_card(cuda):
    """640x480 frames with a z drift: the fused branch's fields and gather
    kernels and one scan, and no filter stencil (the GEMMs replace it); 65
    of 65 markers in every frame; the drift's sign; the rest frame's
    detections within the reference's 0.01 px of the float32 filters'; every
    detection within 0.1 px and at most 0.1% of the DoG mask's pixels
    flipped (0.0421 px and 0.0230% at 1024 frames, the first reading on the
    H100)."""
    from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    cfg16 = dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, fast_filters=True))
    scene, frames = render_drift(cuda, 480, 640, 32, -0.02)
    ref16 = initialize(frames[0], cfg16)
    out16, launches = counted(lambda: process_frames(frames, ref16, scene.cam,
                                                     cfg16))
    assert launches == {"fields": 1, "gather": 1, "scan": 1}
    assert int(ref16.valid.sum()) == 65
    assert int(out16.tracked.valid.sum(-1).min()) == 65
    assert float(out16.recon.from_first[-1, :, 2].mean()) < 0.0

    out32 = process_frames(frames, initialize(frames[0], cfg), scene.cam, cfg)
    a, b = out32.detections, out16.detections
    d = torch.cdist(a.xy.double(), b.xy.double())
    d = torch.where(b.valid[:, None, :], d, torch.full_like(d, math.inf))
    nearest = d.amin(-1)
    assert float(nearest[0][a.valid[0]].max()) < 0.01
    assert float(nearest[a.valid].max()) <= 0.1

    prof = cfg.detect.low_res
    gray = frames.float()
    m32 = dog_area_mask(gray, prof, cfg.detect.dog_offset)
    m16 = dog_area_mask(gray, prof, cfg.detect.dog_offset, torch.bfloat16)
    assert int((m32 != m16).sum()) <= 1e-3 * m32.numel()
