"""Closed loop of batches (``batch.py``'s, unchanged) whose detection takes
the unfused branch: the check compares with the reference pipeline that
holds that branch (``reference/pipeline_unfused.py``)."""
from __future__ import annotations

from vbs_bench import check
from vbs_bench.loads import batch
from vbs_bench.loads.common import reference_setup
from vbs_bench.reference import pipeline_unfused as ref


class Load(batch.Load):

    def check(self) -> dict:
        """Every batch's outputs against one reference run over the same
        frames (every batch is the same recording)."""
        cfg, cam = reference_setup(self.conf, self.device)
        with ref.precision(tf32=False):
            r = ref.initialize(self.frames[0], cfg)
            want = ref.process_frames(self.frames, r, cam, cfg, self.stats)
        return check.worst(check.pipeline_numbers(got, want)
                           for got in self.kept)
