"""The live loop on the card (``cli/main.py``: ``record``, ``run-live
--tpu-decode --publish --resume``) on a localhost MJPEG stream of rendered
q70 frames, held to ``StreamingPipeline.process`` over the same frames.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``).
"""
import pytest
import torch

from torch_parity import (MjpegServer, assert_same_outputs,  # noqa: F401
                          cuda, render_jpegs, run_card_cli, spy_on_run_live)

from vision_basedsensor_tpu_torch.config import PipelineConfig
from vision_basedsensor_tpu_torch.io import publish
from vision_basedsensor_tpu_torch.ops import jpeg as tj
from vision_basedsensor_tpu_torch.pipeline import StreamingPipeline
from vision_basedsensor_tpu_torch.synth import default_scene

pytestmark = pytest.mark.cuda_only

# run-live's frames and --batch: the frames at most the stream reader's
# max(2 * batch, 8), so none can be dropped.
FRAMES, BATCH = 32, 16


def test_record_and_run_live_on_the_card(cuda, tmp_path, monkeypatch):
    """``record`` stores the served JPEGs byte for byte and launches no
    kernel. ``run-live --tpu-decode --publish 0 --resume`` drops no frame;
    each chunk's outputs equal ``process`` over ``MjpegBatchDecoder``'s
    TDELTA decode of the same JPEGs, its printed lines equal what those
    outputs give, ``/state`` read after each update equals that chunk's
    payload, and the saved session reloads with the frame count and the
    reference table; it launches the expand kernel and the fused
    branch's."""
    from vision_basedsensor_tpu_torch.io.session import load_session
    from vision_basedsensor_tpu_torch.io.video import _iter_avi_video_chunks

    _, jpegs = render_jpegs(cuda, FRAMES)
    srv = MjpegServer(jpegs)
    try:
        avi = tmp_path / "live.avi"
        _, _, launches = run_card_cli(["record", srv.url, str(avi),
                                       "--max-frames", str(FRAMES)])
        assert launches == {}
        assert list(_iter_avi_video_chunks(avi.read_bytes())) == jpegs
        chunks, payloads, served = spy_on_run_live(monkeypatch)
        sess = tmp_path / "session"
        text, _, launches = run_card_cli([
            "run-live", srv.url, "--tpu-decode", "--publish", "0",
            "--resume", str(sess), "--batch", str(BATCH), "--max-frames",
            str(FRAMES)])
    finally:
        srv.close()
        monkeypatch.undo()
    assert set(launches) == {"expand_sorted", "fields", "gather", "filters",
                             "scan"}
    assert "skipped" not in text and len(chunks) == FRAMES // BATCH

    dec = tj.MjpegBatchDecoder(device=cuda)
    sp = StreamingPipeline(default_scene(480, 640, device=cuda).cam,
                           PipelineConfig(), device=cuda)
    lines = []
    for i, got in enumerate(chunks):
        want = sp.process(dec.tdelta_to_device(dec.entropy_decode_tdelta(
            jpegs[i * BATCH:(i + 1) * BATCH])))
        assert_same_outputs(got, want)
        seen = want.recon.seen.cpu().numpy()
        ffn = want.recon.from_first_norm.cpu().numpy()
        lines.append(f"frames {sp.frames_seen}: tracked "
                     f"{int(seen[-1].sum())}/65 markers, mean "
                     f"displacement {float(ffn[seen].mean()):.3f} mm")
        state = publish.contact_state_payload(want.contact, -1,
                                              sp.frames_seen)
        assert payloads[i] == state
        assert served[i] == dict(state, seq=i + 1)
    assert [ln for ln in text.splitlines() if ln.startswith("frames ")] \
        == lines
    loaded = load_session(str(sess), device=cuda)
    assert loaded.frames_seen == FRAMES
    assert torch.equal(loaded.ref.xy, sp.ref.xy)
