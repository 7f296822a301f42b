"""The port's main path on the card (``pipeline.py``: ``process_frames`` on
both detector branches, ``run_video``, ``StreamingPipeline``): what a run
holds beyond each kernel's equality to its plain version
(``tests/test_torch_cuda.py``).

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``):

    python -m pytest --noconftest -m cuda_only tests/test_torch_pipeline_cuda.py
"""
import pytest
import torch

from torch_parity import (check_main_path, counted, cuda,  # noqa: F401
                          render_drift)

from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                 ReconstructConfig,
                                                 TrackConfig)
from vision_basedsensor_tpu_torch.pipeline import (StreamingPipeline,
                                                   initialize,
                                                   prepare_undistortion,
                                                   process_frames, run_video)

pytestmark = pytest.mark.cuda_only

# The main path's configurations, cut to seconds: (rows, cols, batch,
# max_candidates, backend). The reference's two bench sizes on the fused
# branch, the high-res frames on the unfused one, and an odd K (the pack=1
# gather). chip_smoke.py runs the same check at the bench batches.
RUNS = {"640x480": (480, 640, 32, 96, "auto"),
        "1080x1920": (1080, 1920, 8, 96, "auto"),
        "1080x1920-unfused": (1080, 1920, 8, 96, "xla"),
        "640x480-K97": (480, 640, 16, 97, "auto")}
# The rendered drift, mm a frame along z.
DZ_MM = -0.02
# A lens with barrel distortion (tests/test_undistort.py:88).
DIST = (-0.18, 0.05, 0.0, 0.0, 0.0)


@pytest.mark.parametrize("run", list(RUNS))
def test_process_frames_on_the_card(cuda, run):
    """A batch launches exactly its branch's kernels, once each (the two
    filter stencils and one scan); 65 of 65 markers in every frame; finite
    tilt and positions; the rendered drift recovered (at 640x480 within
    0.05 mm + 10%; at 1080x1920 the reference recovers about a third of it,
    so only its sign); the kernels' plain versions give the same
    detections and tilt (the fused branch), or the reference's
    xla-vs-pallas tolerances (the unfused one, which also holds them
    against the fused branch on the same frames)
    (``torch_parity.check_main_path``)."""
    check_main_path(cuda, *RUNS[run], DZ_MM)


def test_stream_chunks_match_one_batch_on_the_card(cuda):
    """Distorted frames through the undistort preprocess with sequential
    association: ``StreamingPipeline`` in chunks against one batch
    (``prepare_undistortion`` + ``initialize`` + ``process_frames``): equal
    validity, axes and displacement paths within 1e-4, 50 or more markers in
    every frame, finite tilt; the fused branch's kernels and the
    association's, one scan and one association launch a call."""
    import numpy as np

    n, chunk = 96, 32
    scene, frames = render_drift(cuda, 480, 640, n, dist=np.asarray(DIST))
    cfg = PipelineConfig(undistort_frames=True,
                         track=TrackConfig(association_mode="sequential"),
                         reconstruct=ReconstructConfig(warmup_frames=0))

    def batch():
        src_map, new_cam = prepare_undistortion(scene.cam, 480, 640, cfg)
        ref = initialize(frames[0], cfg, rectify_map=src_map)
        return process_frames(frames, ref, new_cam, cfg, rectify_map=src_map)

    def chunked():
        sp = StreamingPipeline(scene.cam, cfg, device=cuda)
        return [sp.process(frames[i:i + chunk]) for i in range(0, n, chunk)]

    outs, k_chunked = counted(chunked)
    base, k_batch = counted(batch)
    kernels = {"fields", "gather", "filters", "scan", "associate"}
    for launches, calls in ((k_chunked, n // chunk), (k_batch, 1)):
        assert set(launches) == kernels, launches
        assert launches["scan"] == launches["associate"] == calls, launches
    valid = torch.cat([o.tracked.valid for o in outs])
    assert torch.equal(valid, base.tracked.valid)
    for name, get in (("axes", lambda o: o.tracked.axes),
                      ("cum_path", lambda o: o.recon.cum_path),
                      ("from_first_norm", lambda o: o.recon.from_first_norm)):
        d = torch.cat([get(o) for o in outs]) - get(base)
        assert float(d.abs().max()) <= 1e-4, name
    assert int(valid.sum(-1).min()) >= 50
    assert bool(torch.isfinite(base.contact.tilt_deg).all())


def test_membrane_indentation_on_the_card(cuda):
    """A 1.5 mm probe indentation with membrane flow through ``run_video``
    at 640x480 (the fused branch's kernels and one scan), held to
    tests/test_reconstruct.py:97-131's bounds: 60 or more markers in both
    frames, the median error of x and y under 0.05 mm and of z under 0.10
    mm, the median direction cosine of the in-plane motion over 0.95."""
    from vision_basedsensor_tpu_torch.synth import (default_scene,
                                                    membrane_indentation_field,
                                                    render_frames)

    scene = default_scene(480, 640, device=cuda)
    field = membrane_indentation_field(1.5, contact_xy=(2.0, -1.0),
                                       probe_radius_mm=5.0,
                                       tangential_frac=0.3, device=cuda)
    frames = render_frames(scene, torch.stack([torch.zeros_like(field),
                                               field]))
    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0),
                         track=TrackConfig(association_mode="frame0"))
    out, launches = counted(lambda: run_video(frames, scene.cam, cfg,
                                              apply_warmup=False))
    assert set(launches) == {"fields", "gather", "filters", "scan"}
    assert launches["scan"] == 1
    both = out.recon.seen[0] & out.recon.seen[1]
    f = field.double()
    got = out.recon.from_first[1].double()
    med = (got - f)[both].abs().median(0).values
    mag = torch.hypot(f[:, 0], f[:, 1])
    m = both & (mag > 0.1)
    cos = ((got[m, 0] * f[m, 0] + got[m, 1] * f[m, 1])
           / torch.clamp(torch.hypot(got[m, 0], got[m, 1]) * mag[m],
                         min=1e-9))
    assert int(both.sum()) >= 60
    assert float(med[0]) < 0.05 and float(med[1]) < 0.05, med
    assert float(med[2]) < 0.10, med
    assert float(cos.median()) > 0.95
