"""The acquisition server on the card (``capture/server.py``
``run_server``, synthetic: the dome rendered on the card at the CLI's
640x480, 12 fps, q70) consumed in-process by ``record`` and ``run-live
--tpu-decode --publish``.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``).
"""
import time

import pytest
import torch

from torch_parity import cuda, run_card_cli, spy_on_run_live  # noqa: F401

pytestmark = pytest.mark.cuda_only

# The frames record takes, the frames run-live reads and its --batch (the
# frames at most the stream reader's max(2 * batch, 8): none dropped).
RECORD, LIVE, BATCH = 8, 16, 8


def test_serve_record_and_run_live_on_the_card(cuda, tmp_path, monkeypatch):
    """``record`` of the served stream stores 640x480 JPEGs the native
    decoder reads, with no kernel launched; ``run-live --tpu-decode
    --publish 0`` tracks 65 of 65 markers in every frame with a finite tilt,
    drops nothing, serves the last chunk's payload at ``/state`` and
    launches the expand kernel and the fused branch's; the server's threads
    end at ``stop()``."""
    from vision_basedsensor_tpu_torch.capture import run_server
    from vision_basedsensor_tpu_torch.config import CaptureConfig
    from vision_basedsensor_tpu_torch.io import publish
    from vision_basedsensor_tpu_torch.io.mjpeg import sof_dims
    from vision_basedsensor_tpu_torch.io.video import _iter_avi_video_chunks
    from vision_basedsensor_tpu_torch.ops import jpeg as tj

    cap = CaptureConfig(port=0)
    srv = run_server(cap, synthetic=True, block=False, device=cuda)
    try:
        url = f"http://127.0.0.1:{srv.port}/stream"
        t0 = time.perf_counter()
        while srv.camera.frame is None and time.perf_counter() - t0 < 60:
            time.sleep(0.01)
        avi = tmp_path / "served.avi"
        _, _, launches = run_card_cli(["record", url, str(avi),
                                       "--max-frames", str(RECORD)])
        assert launches == {}
        chunks, payloads, served = spy_on_run_live(monkeypatch)
        text, _, launches = run_card_cli([
            "run-live", url, "--tpu-decode", "--publish", "0", "--batch",
            str(BATCH), "--max-frames", str(LIVE)])
        monkeypatch.undo()
    finally:
        srv.stop()
    assert not [t.name for t in srv._threads if t.is_alive()]

    got = list(_iter_avi_video_chunks(avi.read_bytes()))
    assert len(got) == RECORD
    assert {sof_dims(j) for j in got} == {(cap.width, cap.height)}
    dec = tj.MjpegBatchDecoder(device=cuda)
    x = dec.tdelta_to_device(dec.entropy_decode_tdelta(got))
    assert tuple(x.shape) == (RECORD, cap.height, cap.width)
    assert bool(torch.isfinite(x).all())

    assert set(launches) == {"expand_sorted", "fields", "gather", "filters",
                             "scan"}
    tracked = torch.cat([o.tracked.valid for o in chunks]).sum(-1)
    tilt = torch.cat([o.contact.tilt_deg for o in chunks])
    assert len(chunks) == LIVE // BATCH and tracked.numel() == LIVE
    assert "skipped" not in text
    assert int(tracked.min()) == 65 and bool(torch.isfinite(tilt).all())
    last = publish.contact_state_payload(chunks[-1].contact, -1, LIVE)
    assert payloads[-1] == last
    assert served[-1] == dict(last, seq=len(chunks))
