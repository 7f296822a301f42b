"""The port's replay command line (``vision_basedsensor_tpu_torch/cli/main.py``,
run with ``--device cpu``) against the JAX package's
(``vision_basedsensor_tpu/cli/main.py``) on the same inputs.

Six 240x384 staircase frames rendered by the JAX synth (the fused detector
branch; both CLIs get a ``--config`` with ``backend="pallas"``, which the
JAX package runs in interpret mode on the CPU) are saved as ``.npy`` and,
encoded at q70 with the port's encoder, as an MJPEG ``.avi``. The JAX CLI's
persistent compile cache goes to a temporary directory (``VBS_COMPILE_CACHE``)
and its settings are restored after each call.

Tolerances: positions and axes within 1e-3 px and angles within 1e-2 deg,
as set from the observed agreement (~1e-4 px, the tables' fourth decimal).
An ellipse's orientation is ill-conditioned when its two axes are nearly
equal: the centre marker images as a circle (axes equal to 1e-4 px; the
packages' angles differ by up to 90 deg), and on JPEG frames some markers'
axes differ by only 0.01-0.05 px (angles 0.05 deg apart). Angles are
compared where the axes differ by more than 0.1 px.
"""
import contextlib
import csv
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from torch_parity import render_jax, run_jax_cli, run_port_cli, staircase

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu.cli import main as jcli
from vision_basedsensor_tpu.io import video as jvideo

from vision_basedsensor_tpu_torch.cli import main as tcli
from vision_basedsensor_tpu_torch.io import video as tvideo
from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg

H, W, B = 240, 384, 6
HAS_CV2 = importlib.util.find_spec("cv2") is not None
HAS_PIL = importlib.util.find_spec("PIL") is not None


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    frames, _ = render_jax(H, W, staircase(B, 0.3))
    frames = frames.astype(np.uint8)
    np.save(d / "frames.npy", frames)
    np.save(d / "frame0.npy", frames[0])
    wr = tvideo.MjpegAviWriter(str(d / "clip.avi"), 12.0, (W, H))
    for f in frames:
        wr.write_jpeg(encode_jpeg(f, 70))
    wr.close()
    (d / "cfg.json").write_text(jcfg.to_json(jcfg.PipelineConfig(
        detect=jcfg.DetectConfig(backend="pallas"))))
    return dict(dir=d, npy=str(d / "frames.npy"), frame0=str(d / "frame0.npy"),
                avi=str(d / "clip.avi"), cfg=str(d / "cfg.json"),
                cache=tmp_path_factory.mktemp("jax_cache"))


def _track(inputs, video, *extra):
    """``track video`` through both CLIs (once per module for each set of
    arguments); returns the two markers.csv paths."""
    tag = os.path.basename(video).replace(".", "_") + "".join(extra)
    if tag in inputs:
        return inputs[tag]
    paths = inputs[tag] = {}
    for pkg in ("jax", "port"):
        out = inputs["dir"] / f"{pkg}_{tag}"
        argv = ["--config", inputs["cfg"], "track", video, "--output-dir",
                str(out), *extra]
        if pkg == "jax":
            run_jax_cli(argv, inputs["cache"])
        else:
            run_port_cli(argv)
        paths[pkg] = str(out / "markers.csv")
    return paths


def _rows(path, key_cols, value_cols):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {tuple(int(r[k]) for k in key_cols):
            np.array([float(r[c]) for c in value_cols]) for r in rows}


_TRACK_VALUES = ("Ox", "Oy", "Cx", "Cy", "major_axis", "minor_axis", "angle")


def _compare_tracks(paths, tie_markers_allowed=0):
    want = _rows(paths["jax"], ("frameno", "marker_id"), _TRACK_VALUES)
    got = _rows(paths["port"], ("frameno", "marker_id"), _TRACK_VALUES)
    assert got.keys() == want.keys()
    assert len(got) >= B * 55          # the crop cuts off a few markers
    off = set()
    for key, w in want.items():
        g = got[key]
        err = np.abs(g[:6] - w[:6]).max()
        if err > 1e-3:
            off.add(key[1])
            assert err <= 0.1, (key, g, w)
            continue
        if w[4] - w[5] > 0.1:
            d_angle = (g[6] - w[6] + 90.0) % 180.0 - 90.0
            assert abs(d_angle) <= 1e-2, (key, g[6], w[6])
    assert len(off) <= tie_markers_allowed, sorted(off)


def test_detect_matches_jax(inputs):
    argv = ["--config", inputs["cfg"], "detect", inputs["frame0"]]
    cols = ("x", "y", "major_axis", "minor_axis")

    def parse(text):
        rows = list(csv.DictReader(io.StringIO(text)))
        return {(int(r["marker_id"]), int(r["ring"])):
                np.array([float(r[c]) for c in cols]) for r in rows}

    want = parse(run_jax_cli(argv, inputs["cache"]))
    got = parse(run_port_cli(argv))
    assert got.keys() == want.keys() and len(got) >= 60
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-3,
                                   err_msg=str(key))


def test_track_matches_jax(inputs):
    _compare_tracks(_track(inputs, inputs["npy"]))


def test_track_tpu_decode_matches_jax(inputs):
    """Both packages' device decode of the same ``.avi``. On q70 JPEG noise
    one marker's NCC peak has two near-equal pixels, and the last-bit
    difference of the NCC field picks the other one in frame 0, so that
    marker sits ~0.07 px off in every frame: at most two markers may differ
    by up to 0.1 px, the bound of tests/test_torch_video.py."""
    _compare_tracks(_track(inputs, inputs["avi"], "--tpu-decode"),
                    tie_markers_allowed=2)


@pytest.mark.skipif(not (HAS_CV2 or HAS_PIL),
                    reason="host decode needs cv2 or PIL")
def test_track_host_decode_matches_jax(inputs):
    """``track clip.avi`` without ``--tpu-decode``: both CLIs pick
    ``MjpegAviSource`` and decode the JPEGs on host threads. The same near
    tie as the device decode's may move up to two markers."""
    assert isinstance(tcli._make_source(inputs["avi"]), tvideo.MjpegAviSource)
    _compare_tracks(_track(inputs, inputs["avi"]), tie_markers_allowed=2)


@pytest.mark.parametrize("decoder", ["cv2", "PIL"])
def test_mjpeg_avi_source_matches_jax(inputs, decoder, monkeypatch):
    """The port's ``MjpegAviSource`` frames equal the JAX package's on the
    same ``.avi``, through cv2 and through PIL (where cv2 is absent), and
    stay near the frames that were encoded (q70 JPEG: a mean error of ~2.7
    gray levels; a wrong decode is off by tens)."""
    pytest.importorskip(decoder)
    if decoder == "PIL":
        monkeypatch.setattr(tvideo, "_cv2", lambda: None)
        monkeypatch.setattr(jvideo, "_cv2", None)
    got = list(tvideo.MjpegAviSource(inputs["avi"]).batches(4))
    want = list(jvideo.MjpegAviSource(inputs["avi"]).batches(4))
    assert [g.shape for g in got] == [(4, H, W, 3), (2, H, W, 3)]
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    frames = np.concatenate(got).astype(np.float32)
    assert np.abs(frames - np.load(inputs["npy"])[..., None]).mean() < 4.0


@pytest.mark.skipif(not HAS_CV2, reason="FileVideoSource needs cv2")
def test_make_source_and_file_video_source_match_jax(inputs, tmp_path):
    """``_make_source`` picks ``MjpegAviSource`` for an MJPEG ``.avi`` and
    ``FileVideoSource`` for an XVID one (written by the port's
    ``VideoWriter``), as the JAX CLI does; ``FileVideoSource`` frames equal
    the JAX package's on both files."""
    xvid = str(tmp_path / "clip_xvid.avi")
    vw = tvideo.VideoWriter(xvid, 12.0, (W, H))
    for f in np.load(inputs["npy"]):
        vw.write(f)
    vw.close()
    for path, cls in ((inputs["avi"], "MjpegAviSource"),
                      (xvid, "FileVideoSource")):
        assert type(tcli._make_source(path)).__name__ == cls
        assert type(jcli._make_source(path)).__name__ == cls
        got = np.concatenate(list(tvideo.FileVideoSource(path).batches(4)))
        want = np.concatenate(list(jvideo.FileVideoSource(path).batches(4)))
        assert got.shape == (B, H, W, 3)
        np.testing.assert_array_equal(got, want)


def test_annotate_without_cv2_raises(inputs, tmp_path, monkeypatch):
    """Where cv2 is absent the port's ``VideoWriter`` raises, so ``track
    --annotate`` fails after writing markers.csv and reports no video (the
    JAX package's writer silently writes nothing)."""
    monkeypatch.setattr(tvideo, "_cv2", lambda: None)
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="cv2"), \
            contextlib.redirect_stdout(out):
        tcli.main(["--device", "cpu", "track", inputs["npy"], "--annotate",
                   "--output-dir", str(tmp_path)])
    assert (tmp_path / "markers.csv").exists()
    assert "tracked.avi" not in out.getvalue()
    assert not (tmp_path / "tracked.avi").exists()


def test_reconstruct_matches_jax(inputs, tmp_path, monkeypatch):
    """Both CLIs on the JAX CLI's markers.csv, with the ring analysis; each
    writes its ring plot into the working directory."""
    csv_path = _track(inputs, inputs["npy"])["jax"]
    monkeypatch.chdir(tmp_path)
    outs, ring_line = {}, {}
    for pkg in ("jax", "port"):
        outs[pkg] = tmp_path / f"{pkg}_3d.csv"
        argv = ["reconstruct", csv_path, "--output", str(outs[pkg]),
                "--no-warmup", "--ring", "2"]
        text = (run_jax_cli(argv, inputs["cache"]) if pkg == "jax"
                else run_port_cli(argv))
        ring_line[pkg] = [ln for ln in text.splitlines()
                          if ln.startswith("ring 2 ")]
    key = ("frameno", "marker_id")
    want = _rows(str(outs["jax"]), key, ("Xw", "Yw", "Zw"))
    got = _rows(str(outs["port"]), key, ("Xw", "Yw", "Zw"))
    assert got.keys() == want.keys() and len(got) >= B * 60
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=str(k))
    mag = {pkg: float(line[0].split("displacement ")[1].split(" mm")[0])
           for pkg, line in ring_line.items()}
    assert abs(mag["port"] - mag["jax"]) <= 1e-4, ring_line
    assert mag["port"] > 0.1
    assert (tmp_path / "ring_2_displacement.png").exists()


def test_reconstruct_writes_plots(inputs, tmp_path):
    """``--plots-dir``: one analysis figure per marker with a valid step,
    and the ring figure. On ring 2's rows of the tracking CSV, since
    matplotlib takes ~0.5 s a figure."""
    with open(_track(inputs, inputs["npy"])["port"]) as f:
        lines = f.read().splitlines()
    ring2 = tmp_path / "ring2.csv"
    ring2.write_text("\n".join([lines[0]] + [ln for ln in lines[1:]
                                              if ln.split(",")[2] == "2"]))
    plots = tmp_path / "plots"
    run_port_cli(["reconstruct", str(ring2), "--output",
                  str(tmp_path / "3d.csv"), "--no-warmup", "--ring", "2",
                  "--plots-dir", str(plots)])
    assert sorted(os.listdir(plots)) == sorted(
        [f"marker_{m}_analysis.png" for m in range(8, 20)]
        + ["ring_2_displacement.png"])


def test_annotate_crop_first_frame_matches_jax(inputs, monkeypatch):
    """``--annotate --crop`` draws on the cropped frames; the first written
    frame is pixel-equal to the JAX package's outside the centre marker,
    whose orientation (and so its drawn axes) is undefined."""
    written = {"jax": [], "port": []}
    monkeypatch.setattr(jvideo.VideoWriter, "write",
                        lambda self, f: written["jax"].append(f.copy()))
    monkeypatch.setattr(tvideo.VideoWriter, "write",
                        lambda self, f: written["port"].append(f.copy()))
    paths = _track(inputs, inputs["npy"], "--annotate", "--crop")
    _compare_tracks(paths)
    assert len(written["jax"]) == len(written["port"]) == B
    want, got = written["jax"][0], written["port"][0]
    assert got.shape == want.shape == (225, 288, 3)
    assert (got != np.load(inputs["frame0"])[15:, 48:-48, None]).any()
    rows = _rows(paths["jax"], ("frameno", "marker_id"), _TRACK_VALUES)
    keep = np.ones(got.shape[:2], bool)
    for (t, _), (_, _, cx, cy, major, minor, _) in rows.items():
        if t == 0 and major - minor <= 1e-3:
            r = int(major / 2) + 4
            keep[max(int(cy) - r, 0):int(cy) + r + 1,
                 max(int(cx) - r, 0):int(cx) + r + 1] = False
    assert keep.mean() > 0.95
    np.testing.assert_array_equal(got[keep], want[keep])


def test_tpu_decode_raises_where_jax_falls_back(inputs, tmp_path):
    """The JAX CLI falls back to host decode when its device source cannot
    read the input; the port's ``--tpu-decode`` raises instead."""
    argv = ["track", inputs["npy"], "--tpu-decode", "--output-dir"]
    run_jax_cli([*argv, str(tmp_path / "jax")], inputs["cache"])
    assert (tmp_path / "jax" / "markers.csv").exists()
    with pytest.raises(ValueError, match="movi"):
        run_port_cli([*argv, str(tmp_path / "port")])
    assert not (tmp_path / "port").exists()


def test_cli_needs_the_card_unless_device_cpu(inputs, tmp_path, monkeypatch):
    """Without ``--device cpu`` the CLI builds on CUDA, and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["track", inputs["npy"], "--output-dir", str(tmp_path)])
    assert not (tmp_path / "markers.csv").exists()


@pytest.mark.parametrize("cmd", ["bench"])
def test_unported_subcommands_are_refused(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--device", "cpu", cmd])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
