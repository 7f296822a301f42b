"""The production MJPEG ingest on the card (``io/video.py``:
``MjpegAviCudaSource``, ``device_feed``; ``ops/jpeg.py``'s transports) and
``StreamingPipeline.run`` over it, against ``process`` on the same decoded
frames.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``).
"""
import numpy as np
import pytest
import torch

from torch_parity import (assert_same_outputs, counted, cuda,  # noqa: F401
                          render_jpegs, write_avi)

from vision_basedsensor_tpu_torch.config import PipelineConfig
from vision_basedsensor_tpu_torch.io.video import MjpegAviCudaSource
from vision_basedsensor_tpu_torch.ops import jpeg as tj
from vision_basedsensor_tpu_torch.pipeline import StreamingPipeline

pytestmark = pytest.mark.cuda_only

FRAMES, CHUNK = 48, 16


def test_transport_payloads_match_their_stats_on_the_card(cuda):
    """Each transport's host payload holds the bytes its stats say it
    ships."""
    _, jpegs = render_jpegs(cuda, 8)
    dec = tj.MjpegBatchDecoder(device=cuda)
    for tr in ("dense", "packed", "split", "tdelta"):
        hp = getattr(dec, f"entropy_decode_{tr}")(jpegs)
        nbytes = sum(a.nbytes for a in hp if isinstance(a, np.ndarray))
        assert nbytes == hp.stats["bytes_shipped"], tr


def test_run_over_avi_matches_process_on_the_card(cuda, tmp_path):
    """``StreamingPipeline.run`` over ``MjpegAviCudaSource`` on a q70 .avi
    gives every output of ``process`` over the same decoded frames in the
    same chunks; it launches exactly the fused branch's kernels, the expand
    kernel and one scan a chunk; 65 of 65 markers in every frame."""
    scene, jpegs = render_jpegs(cuda, FRAMES)
    path = write_avi(tmp_path / "ingest.avi", jpegs)
    cfg = PipelineConfig()

    def run():
        sp = StreamingPipeline(scene.cam, cfg, device=cuda)
        return list(sp.run(MjpegAviCudaSource(path, device=cuda), CHUNK))

    outs, launches = counted(run)
    chunks = FRAMES // CHUNK
    assert set(launches) == {"fields", "gather", "filters", "expand_sorted",
                             "scan"}
    assert launches["scan"] == chunks
    decoded = list(MjpegAviCudaSource(path, device=cuda).batches(CHUNK))
    sp = StreamingPipeline(scene.cam, cfg, device=cuda)
    pouts = [sp.process(f) for f in decoded]
    assert len(outs) == len(pouts) == chunks
    for a, b in zip(outs, pouts):
        assert_same_outputs(a, b)
    tracked = torch.cat([o.tracked.valid for o in outs]).sum(-1)
    assert tracked.numel() == FRAMES and int(tracked.min()) == 65
