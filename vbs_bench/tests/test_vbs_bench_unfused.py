"""The unfused-branch cell ``fhd_unfused_batch48`` on the CPU, at a size the
CPU holds: sound, it is correct; with a fault planted in what the program
returns, it is not; the reference in the program's place reads 0; the two
frozen detector branches agree; the window sums' bound counts what a hand
count gives."""
import math

import pytest
import torch

from test_vbs_bench_faults import Broken
from vbs_bench import check, manifest, roofline
from vbs_bench.control_unfused import readings
from vbs_bench.gen.scene import render_uint8
from vbs_bench.reference import config as ref_config
from vbs_bench.reference import detector, unfused
from vbs_bench.reference.moments import CutGeometry
from vbs_bench.reference.peaks import Peaks
from vbs_bench.run import run_cell
from vbs_bench.window_sums_bound import window_sums_bound_s

CPU = torch.device("cpu")
CELL = "fhd_unfused_batch48"
SEED = 2**31 + 99
M = manifest.load()


def run(program=None, batch=1):
    return run_cell(CELL, SEED, 0.3, False, CPU, program=program,
                    traffic_overrides={"batch": batch})


def test_the_cell_is_in_the_manifest_without_problems():
    assert manifest.problems(M) == []
    cell = manifest.cell(M, CELL)
    assert cell["chips"] == 1
    conf = manifest.config(M, cell)
    assert conf["pipeline"]["detect"] == {"backend": "xla"}
    cfg = ref_config._from_jsonable(ref_config.PipelineConfig,
                                    conf["pipeline"])
    prof = cfg.detect_profile(conf["height"])
    assert not detector.takes_fused_branch(cfg.detect, conf["height"],
                                           conf["width"], prof)


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(t["value"] == 0.0 for t in r["checks"].values())


# Two frames: at one, half of the batch is the whole batch and every frame
# is the first, whose displacement from the first is 0.
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer"])
def test_a_fault_is_not_correct(fault):
    r = run(Broken(fault), batch=2)
    assert not r["correct"], r["checks"]


def test_the_reference_in_the_programs_place_reads_zero():
    for _, r in readings(CELL, [SEED], 0.3, CPU, tf32=False,
                         traffic_overrides={"batch": 1}):
        assert r["correct"], r["checks"]
        assert all(t["value"] == 0.0 for t in r["checks"].values())


def test_the_two_frozen_branches_detect_the_same_markers():
    cell = manifest.cell(M, CELL)
    conf = manifest.config(M, cell)
    traffic = manifest.traffic(cell)
    frames = render_uint8(conf["height"], conf["width"], 2, SEED,
                          traffic["motion"], CPU)
    cfg = ref_config._from_jsonable(ref_config.PipelineConfig,
                                    conf["pipeline"])
    fused_cfg = ref_config.PipelineConfig()
    want = detector.detect_markers(frames, fused_cfg.detect)
    got = unfused.detect_markers(frames, cfg.detect)
    limit = manifest.traffic(manifest.cell(M, "fhd_batch48"))["limits"]
    assert int(got.valid.sum()) >= 2 * 65
    assert check.set_gap(got.xy, got.valid, want.xy,
                         want.valid) <= limit["det_px"]


def test_frames_that_take_the_fused_branch_are_routed_to_it():
    frames = render_uint8(480, 640, 1, SEED, {"drift_z_mm_per_frame": 0.0,
                                              "tilt_deg": [0.5, 0.5]}, CPU)
    cfg = ref_config.PipelineConfig().detect
    want, ws, gs = [], [], []
    a = detector.detect_markers(frames, cfg, stats=ws)
    b = unfused.detect_markers(frames, cfg, stats=gs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ws == gs and "window_pixels" in gs[0]


def test_window_stats_match_a_hand_count():
    # One frame, two peaks one pixel apart, cut by the 1-px disk alone:
    # each keeps its centre and four neighbours, two pixels shared.
    prof = ref_config.DetectProfile(patch_size=4, radial_cutoff_px=1.0)
    xy = torch.tensor([[[4.0, 4.0], [5.0, 4.0]]])
    peaks = Peaks(xy=xy, score=torch.ones(1, 2),
                  valid=torch.ones(1, 2, dtype=torch.bool))
    z = torch.zeros(1, 2, 3)
    geom = CutGeometry(ex=z, ey=z, rhs=torch.full_like(z, math.inf))
    assert unfused.window_stats(peaks, geom, prof, 10, 10) == (10, 8)


def test_window_sums_bound_matches_a_hand_count():
    # 2 peaks, 4-px patches, 10 gated visits of 8 distinct pixels:
    # bytes 8 x 12 + 2 x 156 = 408; operations 2 x 4 x 51 + 10 x 59 = 998
    # with a soft floor, 10 x 55 = 958 without.
    assert window_sums_bound_s(2, 4, 0.08, 10, 8) == max(
        408 / roofline.HBM_BYTES_PER_S, 998 / roofline.F32_OPS_PER_S)
    assert window_sums_bound_s(2, 4, 0.0, 10, 8) == max(
        408 / roofline.HBM_BYTES_PER_S, 958 / roofline.F32_OPS_PER_S)
    # At the cell's shape the bytes bound it: for example 48 x 96 peaks of
    # 64-px patches, 1,500 gated visits and 1,300 distinct pixels a peak.
    bk = 48 * 96
    t = window_sums_bound_s(bk, 64, 0.08, 1500 * bk, 1300 * bk)
    assert t == (12 * 1300 * bk + 156 * bk) / roofline.HBM_BYTES_PER_S
