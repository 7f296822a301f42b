"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every test here is ``cuda_only`` and skips without a GPU. The file imports
neither jax nor the JAX package, so it also runs where JAX is absent, with
the JAX-forcing ``tests/conftest.py`` left out:

    python -m pytest --noconftest -m cuda_only tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from vision_basedsensor_tpu_torch.config import DetectConfig, PipelineConfig
from vision_basedsensor_tpu_torch.ops.cuda import fields as kf
from vision_basedsensor_tpu_torch.ops.cuda import moments as kg
from vision_basedsensor_tpu_torch.ops.peaks import Peaks

pytestmark = pytest.mark.cuda_only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _random_fields(rng, b, h, w, dev):
    # Quantized scores: exact plateaus inside and across cells.
    ncc = np.round(rng.random((b, h, w)) * 8.0) / 8.0
    area = rng.random((b, h, w)) > 0.6
    gray = rng.integers(0, 256, (b, h, w))
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in (ncc, area, gray))


def _peaks(rng, b, k, h, w, dev):
    xs = rng.integers(0, w, (b, k)).astype(np.float32)
    ys = rng.integers(0, h, (b, k)).astype(np.float32)
    xs[:, 0], ys[:, 1], xs[:, 2], ys[:, 3] = 0, 0, w - 1, h - 1
    xy = torch.as_tensor(np.stack([xs, ys], -1), device=dev)
    return Peaks(xy=xy, score=torch.ones((b, k), device=dev),
                 valid=torch.ones((b, k), dtype=torch.bool, device=dev))


@pytest.mark.parametrize("shape,profile", [((2, 480, 640), "low_res"),
                                           ((1, 1080, 1920), "high_res"),
                                           ((2, 437, 467), "low_res"),
                                           ((1, 61, 77), "high_res")])
def test_fields_kernel_matches_plain(cuda, shape, profile):
    cfg = DetectConfig()
    prof = getattr(cfg, profile)
    ncc, area, gray = _random_fields(np.random.default_rng(1), *shape, cuda)
    before = kf.fields_launches
    got = kf.fused_fields(ncc, area, gray, cfg.ncc_threshold, cfg.open_ksize,
                          prof)
    want = kf.fused_fields_reference(ncc, area, gray, cfg.ncc_threshold,
                                     cfg.open_ksize, prof)
    torch.cuda.synchronize()
    assert kf.fields_launches == before + 1
    for a, b, name in zip(got, want, ("packed", "cval", "cidx")):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("profile,hw", [("low_res", (480, 640)),
                                        ("high_res", (1080, 1920)),
                                        ("low_res", (437, 467))])
@pytest.mark.parametrize("pack,k", [(1, 96), (2, 96), (1, 97)])
def test_gather_kernel_matches_plain(cuda, profile, hw, pack, k):
    h, w = hw
    prof = getattr(DetectConfig(), profile)
    rng = np.random.default_rng(2)
    packed = torch.as_tensor(rng.integers(0, 1024, (3, h, w)),
                             dtype=torch.float32, device=cuda)
    peaks = _peaks(rng, 3, k, h, w, cuda)
    before = kg.gather_launches
    got, start = kg.gather_windows(packed, peaks, None, prof, pack=pack)
    want = kg.gather_windows_reference(packed, start, prof.patch_size, pack)
    torch.cuda.synchronize()
    assert kg.gather_launches == before + 1
    assert torch.equal(got, want)


def test_wrappers_refuse_bad_inputs(cuda):
    cfg = DetectConfig()
    ncc, area, gray = _random_fields(np.random.default_rng(3), 1, 64, 96, cuda)
    with pytest.raises(TypeError):
        kf.fused_fields(ncc.double(), area, gray, 0.1, 5, cfg.low_res)
    with pytest.raises(ValueError):
        kf.fused_fields(ncc.transpose(1, 2).contiguous().transpose(1, 2),
                        area, gray, 0.1, 5, cfg.low_res)
    with pytest.raises(ValueError):
        kf.fused_fields(ncc, area.cpu(), gray, 0.1, 5, cfg.low_res)


@pytest.mark.parametrize("k", [96, 97])
def test_pipeline_kernel_path_matches_plain_path(cuda, k):
    """The main path on the card, with and without the kernels, on rendered
    frames: identical detections and tilt. An odd K takes the pack=1
    gather."""
    import dataclasses

    from vision_basedsensor_tpu_torch.detect import detector
    from vision_basedsensor_tpu_torch.pipeline import run_video
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames

    scene = default_scene(480, 640, device=cuda)
    d = torch.zeros((6, 65, 3), device=cuda)
    d[:, :, 2] = -0.3 * torch.arange(6, device=cuda)[:, None]
    frames = render_frames(scene, d)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, max_candidates=k))
    f0, g0 = kf.fields_launches, kg.gather_launches
    out = run_video(frames, scene.cam, cfg, apply_warmup=False)
    assert kf.fields_launches > f0 and kg.gather_launches > g0
    assert int(out.tracked.valid.sum(-1).min()) == 65

    def plain_gather(pack):
        def gather(packed, peaks, geom, prof):
            start = kg._prep(packed.shape[1], packed.shape[2], peaks, prof)
            return (kg.gather_windows_reference(packed, start,
                                                prof.patch_size, pack), start)
        return gather

    saved = (detector.fused_fields, detector.gather_windows_paired,
             detector.gather_windows)
    detector.fused_fields = kf.fused_fields_reference
    detector.gather_windows_paired = plain_gather(2)
    detector.gather_windows = plain_gather(1)
    try:
        plain = run_video(frames, scene.cam, cfg, apply_warmup=False)
    finally:
        (detector.fused_fields, detector.gather_windows_paired,
         detector.gather_windows) = saved
    for name in out.detections._fields:
        assert torch.equal(getattr(out.detections, name),
                           getattr(plain.detections, name)), name
    assert torch.equal(out.contact.tilt_deg, plain.contact.tilt_deg)
