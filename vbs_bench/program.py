"""The system under test, ``vision_basedsensor_tpu_torch``: the entry points
that the cells drive (``initialize``, ``process_frames``, ``stream``: a
``StreamingPipeline`` session, ``track_video``: the CLI's replay command)
and the layer functions that a traced run wraps in spans. Nothing else of
the program is read."""
from __future__ import annotations

import contextlib
import sys


class Program:
    """The port on ``device``."""

    def __init__(self, device):
        import vision_basedsensor_tpu_torch.io.table as table
        import vision_basedsensor_tpu_torch.pipeline as pipeline
        from vision_basedsensor_tpu_torch import config
        from vision_basedsensor_tpu_torch.cli import main as cli
        from vision_basedsensor_tpu_torch.core.camera import CameraModel
        self.device = device
        self._pipeline, self._table, self._cli = pipeline, table, cli
        self._config, self._camera = config, CameraModel

    def build(self, ingest: bool) -> None:
        """Build or load the CUDA kernels (and, for ``ingest``, the native
        entropy decoder) in the checkout's ``build/``."""
        if self.device.type != "cuda":
            return
        from vision_basedsensor_tpu_torch.ops.cuda import build
        build.library()
        if ingest:
            from vision_basedsensor_tpu_torch.native import load_jpeg_lib
            load_jpeg_lib()

    def config(self, overrides: dict):
        return self._config._from_jsonable(self._config.PipelineConfig,
                                           overrides)

    def camera(self, numbers: dict):
        return self._camera.create(**numbers, device=self.device)

    def initialize(self, frame, cfg):
        return self._pipeline.initialize(frame, cfg)

    def process_frames(self, frames, ref, cam, cfg):
        return self._pipeline.process_frames(frames, ref, cam, cfg)

    def stream(self, cam, cfg, ref):
        """A streaming session from the frame-0 table ``ref``: an object
        whose ``process(frames)`` runs one chunk and advances the session's
        state (the scan's carry, the association state)."""
        return self._pipeline.StreamingPipeline(cam, cfg, ref=ref,
                                                device=self.device)

    def track_video(self, path: str, chunk: int, out_dir: str) -> None:
        """``vbs-torch track <path> --tpu-decode --chunk <chunk>
        --output-dir <out_dir>``, in this process; its own printing goes to
        standard error."""
        argv = ["--device", self.device.type, "track", path, "--tpu-decode",
                "--chunk", str(chunk), "--output-dir", out_dir]
        with contextlib.redirect_stdout(sys.stderr):
            self._cli.main(argv)

    def layer_targets(self) -> list:
        """``(module, attribute, layer)`` of each layer function that
        ``pipeline.py`` calls and of the table writer."""
        p = self._pipeline
        return [(p, "detect_markers", "detect_markers"),
                (p, "_associate", "associate"),
                (p, "reconstruct_sequence", "reconstruct_sequence"),
                (p, "reconstruct_positions", "reconstruct_positions"),
                (p, "displacement_scan", "displacement_scan"),
                (p, "contact_state_sequence", "contact_state_sequence"),
                (self._table, "write_tracking_csv", "write_tracking_csv")]

