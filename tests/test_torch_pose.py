"""The port's pose-compensation commands (``analyze``, ``tilt``, ``indent``,
run with ``--device cpu``) and the deviation analysis under them
(``analysis/force.py:deviation_field``, ``analyze_deviation``) against the
JAX package's on the same inputs.

Videos are 240x384 frames rendered by the JAX synth; both CLIs get a
``--config`` with ``backend="pallas"`` (the JAX package runs it in interpret
mode on the CPU) and no warm-up frames. Tolerances: the printed tilt within
0.01 deg, the experiment TXTs and the indentation rows within 1e-4 mm (the
observed agreement is the printed digits); the module parity within 1e-5.
"""
import csv
import io

import numpy as np
import pytest
import torch

from torch_parity import (f32, np_, render_jax, run_jax_cli, run_port_cli,
                          to_jax, to_torch)

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu import layout as jlayout
from vision_basedsensor_tpu.analysis import force as jforce
from vision_basedsensor_tpu.io.table import write_experiment_txt
from vision_basedsensor_tpu.synth import render as jrender

from vision_basedsensor_tpu_torch.analysis import force as tforce
from vision_basedsensor_tpu_torch.cli import main as tcli
from vision_basedsensor_tpu_torch.config import AnalysisConfig
from vision_basedsensor_tpu_torch.io.table import read_experiment_txt
from vision_basedsensor_tpu_torch.synth import render as trender

H, W = 240, 384


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pose")
    zero = np.zeros((65, 3), np.float32)
    press = zero + np.float32([0.0, 0.0, -1.0])
    tilt = f32(jrender.tilt_deviation_field(15.0, compression_mm=1.0))
    stair = f32(jrender.indentation_staircase(num_steps=6, step_mm=0.7))
    for name, disp in (("vert", np.stack([zero, press])),
                       ("tilt", np.stack([zero, tilt])), ("stair", stair)):
        frames, _ = render_jax(H, W, disp)
        np.save(d / f"{name}.npy", frames.astype(np.uint8))
    (d / "cfg.json").write_text(jcfg.to_json(jcfg.PipelineConfig(
        detect=jcfg.DetectConfig(backend="pallas"),
        reconstruct=jcfg.ReconstructConfig(warmup_frames=0))))
    return dict(cache=tmp_path_factory.mktemp("jax_cache"),
                **{k: str(d / f"{k}.npy") for k in ("vert", "tilt", "stair")},
                cfg=str(d / "cfg.json"))


def _both(inputs, argv_of):
    """Standard output of ``argv_of(pkg)`` through each package's CLI."""
    return {"jax": run_jax_cli(argv_of("jax"), inputs["cache"]),
            "port": run_port_cli(argv_of("port"))}


def _number(text, key):
    line = next(ln for ln in text.splitlines() if key in ln)
    return float(line.split(key)[1].split()[0])


@pytest.fixture(scope="module")
def experiment_txts(tmp_path_factory):
    """The vertical and 15 deg tilted exports of the JAX package's
    ``tests/test_cli.py:test_cli_analyze``."""
    d = tmp_path_factory.mktemp("txt")
    table = jlayout.dome_layout()[:, 1:]
    valid = np.ones(65, bool)
    tilt_end = table.copy()
    tilt_end[:, 2] += -1.0 - np.tan(np.deg2rad(15.0)) * table[:, 0]
    write_experiment_txt(str(d / "vert.txt"), table, table + [0, 0, -1.0],
                         valid)
    write_experiment_txt(str(d / "tilt.txt"), table, tilt_end, valid)
    return str(d / "vert.txt"), str(d / "tilt.txt")


@pytest.mark.parametrize("mode", ["plane", "shell"])
def test_analyze_matches_jax(inputs, experiment_txts, mode):
    """The printed tilt (2 decimals) and mean deviation magnitude (4
    decimals) equal the JAX CLI's."""
    out = _both(inputs, lambda pkg: ["analyze", *experiment_txts, "--mode",
                                     mode])
    assert out["port"] == out["jax"]
    assert abs(_number(out["port"], "Tilt Angle = ") - 15.0) < 0.01
    assert _number(out["port"], "magnitude: ") > 1.0


def test_analyze_writes_the_deviation_plot(experiment_txts, tmp_path):
    plot = tmp_path / "dev.png"
    out = run_port_cli(["analyze", *experiment_txts, "--plot", str(plot)])
    assert f"wrote {plot}" in out and plot.stat().st_size > 0


def test_tilt_matches_jax(inputs, tmp_path):
    """``tilt`` on a vertical and a 15 deg tilted compression: the printed
    tilt within 0.01 deg of the JAX CLI's, the same common markers, and the
    experiment TXTs within 1e-4 mm."""
    out = _both(inputs, lambda pkg: [
        "--config", inputs["cfg"], "tilt", inputs["vert"], inputs["tilt"],
        "--no-warmup", "--start-range", "0", "0", "--end-range", "1", "1",
        "--output-dir", str(tmp_path / pkg)])
    tilt = {k: _number(v, "Tilt Angle = ") for k, v in out.items()}
    assert abs(tilt["port"] - tilt["jax"]) <= 0.01, out
    assert abs(tilt["port"] - 15.0) < 0.5
    markers = {k: _number(v, "common markers: ") for k, v in out.items()}
    assert markers["port"] == markers["jax"] >= 55
    mag = {k: _number(v, "magnitude: ") for k, v in out.items()}
    assert abs(mag["port"] - mag["jax"]) <= 1e-4
    for tag in ("vertical", "tilted"):
        got = read_experiment_txt(str(tmp_path / "port" / f"{tag}.txt"))
        want = read_experiment_txt(str(tmp_path / "jax" / f"{tag}.txt"))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=1e-4, err_msg=tag)


def _indent_rows(text):
    rows = list(csv.DictReader(io.StringIO(
        "\n".join(ln for ln in text.splitlines() if not ln.startswith("#")))))
    return [(int(r["step"]), int(r["markers"]),
             np.array([float(r[k]) for k in ("prescribed_mm", "measured_mm",
                                             "cumulative_error_mm",
                                             "step_error_mm")]))
            for r in rows]


def test_indent_matches_jax(inputs, tmp_path, capsys):
    """``indent`` on a 6-step 0.7 mm staircase, sequential association (the
    default): every step's row within 1e-4 mm of the JAX CLI's, with the
    same marker counts; the ``--output`` CSV likewise."""
    csvs = {pkg: tmp_path / f"{pkg}.csv" for pkg in ("jax", "port")}
    out = _both(inputs, lambda pkg: [
        "--config", inputs["cfg"], "indent", inputs["stair"], "--steps", "6",
        "--step-mm", "0.7", "--output", str(csvs[pkg])])
    err = capsys.readouterr().err
    assert err.count("worst single-step error") == 2
    for got, want in ((out["port"], out["jax"]),
                      (csvs["port"].read_text(), csvs["jax"].read_text())):
        got, want = _indent_rows(got), _indent_rows(want)
        assert [r[:2] for r in got] == [r[:2] for r in want]
        assert len(got) == 6 and min(r[1] for r in got) >= 55
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[2], w[2], atol=1e-4, err_msg=str(g))


def test_indent_too_few_frames_exits_2(inputs, tmp_path, capsys):
    """A video shorter than one full step: both CLIs exit 2 with the same
    message."""
    short = tmp_path / "short.npy"
    np.save(short, np.load(inputs["stair"])[:1])
    for run in (lambda a: run_jax_cli(a, inputs["cache"]), run_port_cli):
        with pytest.raises(SystemExit) as e:
            run(["--config", inputs["cfg"], "indent", str(short), "--steps",
                 "3"])
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.count("fewer than one full step") == 2


def test_indent_writes_the_error_plot(inputs, tmp_path, capsys):
    plot = tmp_path / "err.png"
    run_port_cli(["--config", inputs["cfg"], "indent", inputs["stair"],
                  "--steps", "2", "--plot", str(plot)])
    assert f"wrote {plot}" in capsys.readouterr().err
    assert plot.stat().st_size > 0


def test_pose_commands_need_the_card_unless_device_cpu(inputs, experiment_txts,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["analyze", *experiment_txts],
                 ["tilt", inputs["vert"], inputs["tilt"]],
                 ["indent", inputs["stair"]]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(argv)


@pytest.mark.parametrize("mode", ["plane", "shell"])
@pytest.mark.parametrize("robust", [False, True])
def test_deviation_analysis_matches_jax(mode, robust):
    """``deviation_field`` and ``analyze_deviation`` on seeded deviation
    fields with partial validity (and three outliers, which the robust fit
    down-weights) against the JAX package's."""
    rng = np.random.default_rng(11)
    table = jlayout.dome_layout()[:, 1:]
    d_vert = rng.normal(0.0, 0.05, (65, 3)) + [0.0, 0.0, -1.0]
    d_tilt = d_vert.copy()
    d_tilt[:, 2] -= np.tan(np.deg2rad(7.0)) * table[:, 0]
    d_tilt[[3, 17, 40], 2] += 4.0
    ok_v, ok_t = rng.random(65) > 0.1, rng.random(65) > 0.1
    cfg = AnalysisConfig(robust_plane_fit=robust)
    jdev, jok = jforce.deviation_field(to_jax(d_vert), ok_v, to_jax(d_tilt),
                                       ok_t)
    want = jforce.analyze_deviation(jdev, jok, jcfg.AnalysisConfig(
        robust_plane_fit=robust), initial_mode=mode)
    tdev, tok = tforce.deviation_field(to_torch(d_vert), torch.from_numpy(ok_v),
                                       to_torch(d_tilt), torch.from_numpy(ok_t))
    got = tforce.analyze_deviation(tdev, tok, cfg, initial_mode=mode)
    np.testing.assert_array_equal(np_(got.valid), np_(want.valid))
    np.testing.assert_allclose(np_(got.deviation), f32(want.deviation),
                               atol=1e-6)
    for name in ("tilt_deg", "mean_vector", "mean_magnitude"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   f32(getattr(want, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for name in ("a", "b", "c"):
        np.testing.assert_allclose(np_(getattr(got.plane, name)),
                                   f32(getattr(want.plane, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert 5.0 < float(got.tilt_deg) < 12.0


def test_synth_sequences_match_jax():
    got = trender.indentation_staircase(5, 0.4, frames_per_step=3,
                                        device="cpu")
    want = jrender.indentation_staircase(5, 0.4, frames_per_step=3)
    assert got.shape == (16, 65, 3)
    np.testing.assert_array_equal(np_(got), f32(want))
    for axis in ("y", "x"):
        np.testing.assert_array_equal(
            np_(trender.tilt_deviation_field(12.0, axis, 0.5, device="cpu")),
            f32(jrender.tilt_deviation_field(12.0, axis, 0.5)))
