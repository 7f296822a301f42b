"""The replay command line on the card (``cli/main.py``: ``track
--tpu-decode``, ``track`` on a ``.npy``, ``reconstruct``, ``detect``), each
held to the library calls it stands for: byte-equal files, and exactly the
kernels those calls launch.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``).
"""
import numpy as np
import pytest
import torch

from torch_parity import (cuda, render_jpegs, run_card_cli,  # noqa: F401
                          write_avi)

from vision_basedsensor_tpu_torch.config import PipelineConfig
from vision_basedsensor_tpu_torch.io.table import write_tracking_csv
from vision_basedsensor_tpu_torch.io.video import MjpegAviCudaSource
from vision_basedsensor_tpu_torch.pipeline import StreamingPipeline
from vision_basedsensor_tpu_torch.synth import default_scene

pytestmark = pytest.mark.cuda_only

FRAMES, CHUNK = 48, 16
FUSED = {"fields", "gather", "filters", "scan"}


@pytest.fixture(scope="module")
def avi(cuda, tmp_path_factory):
    """A q70 640x480 .avi of rendered frames with a z drift."""
    _, jpegs = render_jpegs(cuda, FRAMES)
    return write_avi(tmp_path_factory.mktemp("cli") / "clip.avi", jpegs)


def _stream(dev):
    """The CLI's default pipeline at 640x480."""
    return StreamingPipeline(default_scene(480, 640, device=dev).cam,
                             PipelineConfig(), device=dev)


def _write_tracked(outs, path):
    """markers.csv of pipeline outputs, as ``track`` writes it; returns the
    validity ``(frames, 65)``."""
    from vision_basedsensor_tpu_torch.cli.main import _host

    tr = [_host(o.tracked) for o in outs]

    def cat(k):
        return np.concatenate([getattr(x, k) for x in tr])

    write_tracking_csv(str(path), tr[0]._replace(
        xy=cat("xy"), axes=cat("axes"), angle=cat("angle"),
        valid=cat("valid")))
    return cat("valid")


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def _track_tpu_decode(avi, out_dir):
    _, _, launches = run_card_cli(["track", avi, "--tpu-decode", "--chunk",
                                   str(CHUNK), "--output-dir", str(out_dir)])
    return out_dir / "markers.csv", launches


def test_track_tpu_decode_matches_run_on_the_card(cuda, avi, tmp_path):
    """``track --tpu-decode`` writes the markers.csv of
    ``StreamingPipeline.run`` over ``MjpegAviCudaSource`` on the same file,
    65 of 65 markers in every frame, and launches the ingest's kernels."""
    csv, launches = _track_tpu_decode(avi, tmp_path / "tpu")
    assert set(launches) == FUSED | {"expand_sorted"}
    want = tmp_path / "run_markers.csv"
    valid = _write_tracked(
        list(_stream(cuda).run(MjpegAviCudaSource(avi, device=cuda), CHUNK)),
        want)
    _same_bytes(csv, want)
    assert valid.shape[0] == FRAMES and valid.sum(-1).min() == 65


def test_track_npy_matches_process_on_the_card(cuda, avi, tmp_path):
    """``track`` on the decoded frames saved as .npy writes the markers.csv
    of ``StreamingPipeline.process`` over them in the same chunks."""
    decoded = torch.cat(list(MjpegAviCudaSource(avi, device=cuda)
                             .batches(CHUNK))).to(torch.uint8).cpu()
    npy = tmp_path / "decoded.npy"
    np.save(npy, decoded.numpy())
    _, _, launches = run_card_cli(["track", str(npy), "--chunk", str(CHUNK),
                                   "--output-dir", str(tmp_path / "npy")])
    assert set(launches) == FUSED
    sp = _stream(cuda)
    want = tmp_path / "process_markers.csv"
    _write_tracked([sp.process(decoded[i:i + CHUNK])
                    for i in range(0, FRAMES, CHUNK)], want)
    _same_bytes(tmp_path / "npy" / "markers.csv", want)


def test_reconstruct_matches_reconstruct_sequence_on_the_card(cuda, avi,
                                                               tmp_path):
    """``reconstruct --no-warmup`` on ``track --tpu-decode``'s markers.csv
    writes ``write_coords_table`` of ``reconstruct_sequence`` on
    ``read_tracking_csv``'s arrays, and launches the scan alone."""
    from vision_basedsensor_tpu_torch.cli.main import _host
    from vision_basedsensor_tpu_torch.io.table import (read_tracking_csv,
                                                       write_coords_table)
    from vision_basedsensor_tpu_torch.reconstruct import reconstruct_sequence
    from vision_basedsensor_tpu_torch.track.associate import TrackedFrames

    csv, _ = _track_tpu_decode(avi, tmp_path / "tpu")
    coords = tmp_path / "cli_3d.csv"
    _, _, launches = run_card_cli(["reconstruct", str(csv), "--no-warmup",
                                   "--output", str(coords)])
    assert launches == {"scan": 1}
    data = read_tracking_csv(str(csv))

    def f32(k):
        return torch.as_tensor(data[k], dtype=torch.float32, device=cuda)

    recon = reconstruct_sequence(
        default_scene(480, 640, device=cuda).cam,
        TrackedFrames(xy=f32("xy"), ref_xy=f32("ref_xy"), axes=f32("axes"),
                      angle=f32("angle"),
                      ring=torch.zeros(65, dtype=torch.int32, device=cuda),
                      valid=torch.as_tensor(data["valid"], device=cuda)),
        PipelineConfig().reconstruct, apply_warmup=False)
    want = tmp_path / "sequence_3d.csv"
    write_coords_table(str(want), _host(recon))
    _same_bytes(coords, want)


def test_detect_on_the_card(cuda, avi, tmp_path):
    """``detect`` on the first decoded frame: 65 markers, the fused
    branch's detect kernels alone."""
    frame = next(MjpegAviCudaSource(avi, device=cuda).batches(1))
    npy = tmp_path / "frame0.npy"
    np.save(npy, frame[0].to(torch.uint8).cpu().numpy())
    text, _, launches = run_card_cli(["detect", str(npy)])
    assert set(launches) == FUSED - {"scan"}
    assert len(text.strip().splitlines()[1:]) == 65
