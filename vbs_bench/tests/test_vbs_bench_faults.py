"""A run of each cell, with the chip check skipped, at a size the CPU
holds: sound, it is correct; with the timed path broken underneath, the
comparison with the reference finds it not correct."""
import numpy as np
import pytest
import torch

import vision_basedsensor_tpu_torch.io.table as table
from vbs_bench.control import readings
from vbs_bench.program import Program
from vbs_bench.run import run_cell

CPU = torch.device("cpu")
SEED = 2**31 + 99
SMALL = {"vga_batch1024": {"batch": 3},
         "fhd_batch48": {"batch": 1},
         "vga_replay_avi2048": {"period": 3, "periods": 2, "chunk": 3}}


def run(cell, program=None, seconds=0.3):
    return run_cell(cell, SEED, seconds, False, CPU, program=program,
                    traffic_overrides=SMALL[cell])


def _alter(out, field, sub, fn):
    part = getattr(out, field)
    return out._replace(**{field: part._replace(
        **{sub: fn(getattr(part, sub))})})


class Broken(Program):
    """The port with one fault planted in what ``process_frames``
    returns."""

    def __init__(self, fault):
        super().__init__(CPU)
        self.fault = fault

    def process_frames(self, frames, ref, cam, cfg):
        if self.fault == "half_batch":
            # Half of the batch left out: the first half's results stand
            # in for the rest.
            half = max(frames.shape[0] // 2, 1)
            out = super().process_frames(frames[:half], ref, cam, cfg)
            idx = torch.arange(frames.shape[0]) % half
            pick = lambda x: x[idx] if x.ndim and x.shape[0] == half else x
            return type(out)(*(type(p)(*(pick(x) if isinstance(
                x, torch.Tensor) else x for x in p)) if p is not None
                else None for p in out))
        out = super().process_frames(frames, ref, cam, cfg)
        if self.fault == "state_unchanged":
            # The displacement scan's state never advances: every frame
            # measured against itself.
            return _alter(out, "recon", "from_first", torch.zeros_like)
        if self.fault == "answer":
            # One position altered where it is produced.
            def shift(xy):
                xy = xy.clone()
                xy[-1, 0, 0] += 0.5
                return xy
            return _alter(out, "tracked", "xy", shift)
        raise ValueError(self.fault)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(t["value"] == 0.0 for t in r["checks"].values())


@pytest.mark.parametrize("cell, fault", [
    ("vga_batch1024", "state_unchanged"), ("vga_batch1024", "half_batch"),
    ("vga_batch1024", "answer"), ("fhd_batch48", "answer")])
def test_a_fault_is_not_correct(cell, fault):
    r = run(cell, Broken(fault))
    assert not r["correct"], r["checks"]


def test_a_replay_row_altered_is_not_correct(monkeypatch):
    write = table.write_tracking_csv

    def altered(path, tracked):
        xy = np.asarray(tracked.xy).copy()
        xy[-1, 0, 1] += 0.5
        write(path, tracked._replace(xy=xy))

    monkeypatch.setattr(table, "write_tracking_csv", altered)
    r = run("vga_replay_avi2048")
    assert not r["correct"], r["checks"]
    assert r["checks"]["csv_xy_px"]["value"] > 0.0


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_reference_in_the_programs_place_reads_zero(cell):
    # The control's machinery in float32: the reference where the program
    # stands (the replay's table written as the port's writer writes it).
    for _, r in readings(cell, [SEED], 0.3, CPU, tf32=False,
                         traffic_overrides=SMALL[cell]):
        assert r["correct"], r["checks"]
        assert all(t["value"] == 0.0 for t in r["checks"].values())
