"""The replay command line of the PyTorch port.

Port of ``vision_basedsensor_tpu/cli/main.py`` for the three subcommands of
the offline replay: the operator records the sensor's MJPEG stream to
``.avi``, then replays it.

  detect       single image -> marker centroids + ids
  track        video -> tracking CSV (+ annotated video)
  reconstruct  tracking CSV + calibration -> 3D coordinates

The arguments are the reference's, spelled the same, so a user's scripts run
unchanged. One option is new: ``--device {cuda,cpu}`` (before the
subcommand, default ``cuda``), passed to every constructor; without a card
and without ``--device cpu`` the command raises (``core/device.py``). The
other subcommands of the reference (calibration, analysis, capture, live
streams, ``bench``) are not registered here, so argparse refuses them.

``track --tpu-decode`` reads the video with ``MjpegAviCudaSource`` (host
entropy decode, dequant-IDCT on the device) fed by ``device_feed``. Unlike
the reference, which falls back to host decode when that source cannot be
built, it raises: a user who asks for the device decode gets it or an error.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load_cfg(args):
    from vision_basedsensor_tpu_torch.config import PipelineConfig, from_json
    if getattr(args, "config", None):
        return from_json(args.config)
    return PipelineConfig()


def _make_source(path: str):
    from vision_basedsensor_tpu_torch.io.video import (
        ArrayVideoSource, FileVideoSource, MjpegAviSource)
    if path.endswith((".npy", ".npz")):
        return ArrayVideoSource(path)
    try:
        # MJPG AVIs (what the acquisition stack records) decode on all
        # host cores; other codecs fall back to sequential cv2.
        return MjpegAviSource(path)
    except ValueError:          # not an MJPEG AVI
        return FileVideoSource(path)


def _host(outputs):
    """A named tuple of tensors as numpy arrays: one copy per field."""
    return type(outputs)(*(x.cpu().numpy() for x in outputs))


def _stream_video(path, args, cfg, apply_warmup: bool, chunk: int):
    """Run the full pipeline over a video in bounded host memory.

    Chunks stream through ``StreamingPipeline`` (carried state makes the
    result identical to one batch), and only the small per-frame marker
    outputs accumulate, on the host. Returns ``(tracked, recon, cam,
    pipeline)`` with numpy leaves spanning all frames.
    """
    from vision_basedsensor_tpu_torch.pipeline import StreamingPipeline
    if getattr(args, "tpu_decode", False):
        from vision_basedsensor_tpu_torch.io.video import (MjpegAviCudaSource,
                                                           device_feed)
        # Host entropy decode on a prefetch thread, the device decode on
        # this one, one batch of device lookahead (io/video.py:device_feed).
        batches = device_feed(MjpegAviCudaSource(path, device=args.device),
                              chunk, args.device)
    else:
        batches = _make_source(path).batches(chunk)
    sp, cam = None, None
    tr, rc = [], []
    for batch in batches:
        if sp is None:
            cam = _camera_from_args(args, batch.shape)
            sp = StreamingPipeline(cam, cfg,
                                   crop=getattr(args, "crop", False),
                                   apply_warmup=apply_warmup,
                                   device=args.device)
        out = sp.process(batch)
        tr.append(_host(out.tracked))
        rc.append(_host(out.recon))
    if sp is None:
        raise SystemExit(f"no frames in {path}")
    cat = lambda f, cs: np.concatenate([getattr(c, f) for c in cs])
    tracked = tr[0]._replace(xy=cat("xy", tr), axes=cat("axes", tr),
                             angle=cat("angle", tr), valid=cat("valid", tr))
    recon = type(rc[0])(*[cat(f, rc) for f in rc[0]._fields])
    return tracked, recon, cam, sp


def cmd_detect(args):
    import torch

    from vision_basedsensor_tpu_torch.detect import detect_markers
    from vision_basedsensor_tpu_torch.track import assign_identities
    cfg = _load_cfg(args)
    if args.image.endswith(".npy"):
        img = np.load(args.image)
    else:
        import cv2
        img = cv2.imread(args.image)
    det = detect_markers(torch.as_tensor(img, device=args.device), cfg.detect)
    ref = assign_identities(det, cfg.track)
    valid, xy, axes, ring = (x.cpu().numpy() for x in (ref.valid, ref.xy,
                                                        ref.axes, ref.ring))
    print("marker_id,ring,x,y,major_axis,minor_axis")
    for m in np.where(valid)[0]:
        print(f"{m + 1},{int(ring[m])},{xy[m, 0]:.3f},"
              f"{xy[m, 1]:.3f},{axes[m, 0]:.3f},{axes[m, 1]:.3f}")
    print(f"# detected {valid.sum()} markers", file=sys.stderr)


def cmd_track(args):
    import dataclasses

    from vision_basedsensor_tpu_torch.io.table import write_tracking_csv
    cfg = _load_cfg(args)
    if args.undistort:
        cfg = dataclasses.replace(cfg, undistort_frames=True)
    tracked, _, cam, _ = _stream_video(args.video, args, cfg,
                                       apply_warmup=False, chunk=args.chunk)
    os.makedirs(args.output_dir, exist_ok=True)
    csv_path = os.path.join(args.output_dir, "markers.csv")
    write_tracking_csv(csv_path, tracked)
    print(f"wrote {csv_path}")
    if args.annotate:
        import torch

        from vision_basedsensor_tpu_torch.detect.overlay import draw_tracking
        from vision_basedsensor_tpu_torch.io.video import VideoWriter
        from vision_basedsensor_tpu_torch.pipeline import (_preprocess,
                                                           prepare_undistortion)
        # Tracked coordinates live in the preprocessed (cropped/rectified)
        # frame space, so draw on those frames (the reference annotates the
        # preprocessed frames too, marker_detection.py:434-453). Second
        # streaming pass: frames are decoded again per chunk.
        vw = None
        t = 0
        rectify_map = None
        rectify_hw = None
        for batch in _make_source(args.video).batches(args.chunk):
            draw_frames = batch
            if args.crop or cfg.undistort_frames:
                if cfg.undistort_frames:
                    fh, fw = (int(batch.shape[1]), int(batch.shape[2]))
                    # The rectify map depends only on the frame shape.
                    if rectify_hw != (fh, fw):
                        rectify_map, _ = prepare_undistortion(
                            cam, fh, fw, cfg, args.crop)
                        rectify_hw = (fh, fw)
                draw_frames = _preprocess(
                    torch.as_tensor(batch, device=args.device), cfg,
                    args.crop, rectify_map).cpu().numpy()
            if vw is None:
                h, w = draw_frames.shape[1:3]
                vw = VideoWriter(os.path.join(args.output_dir, "tracked.avi"),
                                 12.0, (w, h))
            for f in draw_frames:
                vw.write(draw_tracking(f, tracked, t))
                t += 1
        vw.close()
        print(f"wrote {os.path.join(args.output_dir, 'tracked.avi')}")


def _load_artifact(args):
    """The json/xlsx calibration-artifact loader of every subcommand."""
    from vision_basedsensor_tpu_torch.calibrate import CalibrationArtifact
    if not getattr(args, "calibration", None):
        return None
    art = CalibrationArtifact.load_json(args.calibration) \
        if args.calibration.endswith(".json") \
        else CalibrationArtifact.load_intrinsics_xlsx(args.calibration)
    if getattr(args, "extrinsics", None):
        art = art.load_extrinsics_xlsx(args.extrinsics)
    return art


def _camera_from_args(args, frame_shape):
    art = _load_artifact(args)
    if art is not None:
        return art.to_camera(device=args.device)
    # Default: nominal synthetic-scene camera for the frame size.
    from vision_basedsensor_tpu_torch.synth import default_scene
    h, w = frame_shape[1:3]
    return default_scene(height=h, width=w, device=args.device).cam


def cmd_reconstruct(args):
    import torch

    from vision_basedsensor_tpu_torch.analysis import displacement_statistics
    from vision_basedsensor_tpu_torch.io.table import (read_tracking_csv,
                                                       write_coords_table)
    from vision_basedsensor_tpu_torch.reconstruct import reconstruct_sequence
    from vision_basedsensor_tpu_torch.track.associate import TrackedFrames
    cfg = _load_cfg(args)
    cam = _camera_from_args(args, (0, 480, 640))
    data = read_tracking_csv(args.tracking_csv)
    f32 = lambda k: torch.as_tensor(data[k], dtype=torch.float32,
                                    device=args.device)
    tracked = TrackedFrames(
        xy=f32("xy"), ref_xy=f32("ref_xy"), axes=f32("axes"),
        angle=f32("angle"),
        ring=torch.zeros(65, dtype=torch.int32, device=args.device),
        valid=torch.as_tensor(data["valid"], device=args.device))
    dev_recon = reconstruct_sequence(cam, tracked, cfg.reconstruct,
                                     apply_warmup=not args.no_warmup)
    recon = _host(dev_recon)
    write_coords_table(args.output, recon)
    stats = _host(displacement_statistics(dev_recon))
    print(f"wrote {args.output}")
    print(f"{int(recon.seen.sum())} marker observations reconstructed")
    if args.plots_dir:
        from vision_basedsensor_tpu_torch.analysis.plots import \
            plot_marker_analysis
        os.makedirs(args.plots_dir, exist_ok=True)
        for m in np.where(stats.count > 0)[0]:
            plot_marker_analysis(recon, m + 1,
                                 os.path.join(args.plots_dir,
                                              f"marker_{m + 1}_analysis.png"))
    if args.ring is not None:
        # Ring-local averaged start/end displacement (the reference's
        # LocalAnalysis.py, C17): positions averaged over two frame windows,
        # by default the reference's (LocalAnalysis.py:14-15, carried in
        # AnalysisConfig) clipped into the video's frame range.
        from vision_basedsensor_tpu_torch import layout
        from vision_basedsensor_tpu_torch.analysis import start_end_displacement
        from vision_basedsensor_tpu_torch.analysis.plots import \
            plot_ring_displacement
        n = recon.world.shape[0]
        acfg = cfg.analysis
        clip = lambda rng: (min(rng[0], n - 1), min(rng[1], n - 1))
        sr = args.start_range or clip(acfg.start_frame_range)
        er = args.end_range or clip(acfg.end_frame_range)
        disp, ok = (x.cpu().numpy() for x in start_end_displacement(
            dev_recon, tuple(sr), tuple(er)))
        first = 1 + sum(layout.RING_COUNTS[:args.ring])
        ids = np.arange(first, first + layout.RING_COUNTS[args.ring])
        mags = np.linalg.norm(disp[ids - 1], axis=-1)
        okr = ok[ids - 1]
        mean_mag = float(mags[okr].mean()) if okr.any() else float("nan")
        print(f"ring {args.ring} (markers {ids[0]}-{ids[-1]}): mean "
              f"displacement {mean_mag:.4f} mm over frames {sr}->{er}")
        out = os.path.join(args.plots_dir or ".",
                           f"ring_{args.ring}_displacement.png")
        if args.plots_dir:
            os.makedirs(args.plots_dir, exist_ok=True)
        plot_ring_displacement(disp, ok, ids, out)
        print(f"wrote {out}")


def main(argv=None):
    from vision_basedsensor_tpu_torch.core.device import resolve

    p = argparse.ArgumentParser(
        prog="vbs-torch",
        description="vision-based tactile sensor replay on the GPU")
    p.add_argument("--config", help="PipelineConfig JSON file")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where every tensor is built (default: the card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="detect markers in a single image")
    d.add_argument("image")
    d.set_defaults(fn=cmd_detect)

    t = sub.add_parser("track", help="track markers through a video")
    t.add_argument("video")
    t.add_argument("--output-dir", default="results")
    t.add_argument("--crop", action="store_true")
    t.add_argument("--undistort", action="store_true",
                   help="undistort frames before detection "
                        "(marker_detection.py:88-109; needs --calibration)")
    t.add_argument("--annotate", action="store_true")
    t.add_argument("--chunk", type=int, default=256,
                   help="streaming chunk size (bounds host RAM)")
    t.add_argument("--tpu-decode", action="store_true",
                   help="MJPG AVIs: native entropy decode on the host, "
                        "dequantization and IDCT on the device via the "
                        "temporal-delta sparse transport; raises for other "
                        "inputs (no fallback to host decode)")
    t.add_argument("--calibration")
    t.add_argument("--extrinsics")
    t.set_defaults(fn=cmd_track)

    r = sub.add_parser("reconstruct")
    r.add_argument("tracking_csv")
    r.add_argument("--output", default="marker_3d_coordinates.csv")
    r.add_argument("--calibration")
    r.add_argument("--extrinsics")
    r.add_argument("--plots-dir")
    r.add_argument("--no-warmup", action="store_true")
    r.add_argument("--ring", type=int, choices=range(1, 6),
                   help="ring-local averaged displacement analysis "
                        "(LocalAnalysis.py semantics; ring 2 = markers "
                        "8-19); writes ring_<N>_displacement.png")
    r.add_argument("--start-range", type=int, nargs=2,
                   help="frame window averaged as the START position "
                        "(default 1-30, reference LocalAnalysis.py:14, "
                        "clipped to the video)")
    r.add_argument("--end-range", type=int, nargs=2,
                   help="frame window averaged as the END position "
                        "(default 120-150, reference LocalAnalysis.py:15, "
                        "clipped to the video)")
    r.set_defaults(fn=cmd_reconstruct)

    args = p.parse_args(argv)
    args.device = resolve(args.device)
    return args.fn(args)


if __name__ == "__main__":
    main()
