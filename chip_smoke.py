#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vision_basedsensor_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py [--out FILE] [--profile]

Phases (any failure raises, so the script exits non-zero and prints no
result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc for sm_90a;
  3. check each kernel against its plain PyTorch version on the card:
     fields at 480x640 (low-res profile), 1080x1920 (high-res) and 437x467,
     gather pack=1 and pack=2 at both profiles (exact equality);
  4. drive the main path (initialize + process_frames) on rendered 640x480
     frames with a z drift, B=1024: 65/65 markers in every frame, finite
     tilt, nonzero kernel launch counts; rerun it with the kernels' plain
     versions and require identical detections; then the same at
     1080x1920, B=48 (the row-tiled size class), and at 640x480, B=64 with
     an odd K=97, where the path takes the pack=1 gather;
  5. for each of those runs, check the path's kernels against their plain
     versions on that run's own frames, and time them and the pipeline
     (kernel path and plain path) with CUDA events / the host clock after
     warm-up.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

# The main path's runs: (label, rows, cols, batch, max_candidates). The
# first two are the reference's bench sizes (bench.py:99-119,476 and
# benchmarks/bench_highres.py); the odd K takes the pack=1 gather.
RUNS = (("640x480", 480, 640, 1024, 96),
        ("1080x1920", 1080, 1920, 48, 96),
        ("640x480 K=97", 480, 640, 64, 97))


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _event_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _wall_s(fn, reps: int) -> list[float]:
    """Host-clock seconds of each of ``reps`` calls of ``fn()``, each ending
    in a synchronize."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the records here")
    ap.add_argument("--profile", action="store_true",
                    help="profile one kernel-path batch per shape "
                         "(torch.profiler): device time by kernel and the "
                         "device's busy share")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vision_basedsensor_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                     ReconstructConfig)
    from vision_basedsensor_tpu_torch.detect import detector
    from vision_basedsensor_tpu_torch.ops.cuda import build
    from vision_basedsensor_tpu_torch.ops.cuda import fields as kf
    from vision_basedsensor_tpu_torch.ops.cuda import moments as kg
    from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask
    from vision_basedsensor_tpu_torch.ops.moments import cut_geometry
    from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian
    from vision_basedsensor_tpu_torch.ops.peaks import select_peaks_from_cells
    from vision_basedsensor_tpu_torch.pipeline import initialize, process_frames
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    records: dict = {"card": card, "phases": {}}

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s (nvcc {build.build_seconds}) -> "
          f"{build.library_path().name} [{card}]", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    records["build_s"] = build_s

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    dcfg = cfg.detect

    def fields_inputs(frames, prof):
        gray = frames.float().contiguous()
        area = dog_area_mask(gray, prof, dcfg.dog_offset).float()
        ncc = normxcorr_gaussian(area, prof.template_size,
                                 prof.template_sigma, binary_input=True)
        return ncc, area, gray

    def fields_plain(ncc, area, gray, prof):
        return kf.fused_fields_reference(ncc, area, gray, dcfg.ncc_threshold,
                                         dcfg.open_ksize, prof)

    def fields_kernel(ncc, area, gray, prof):
        return kf.fused_fields(ncc, area, gray, dcfg.ncc_threshold,
                               dcfg.open_ksize, prof)

    def gather_plain(packed, peaks, prof, pack):
        start = kg._prep(packed.shape[1], packed.shape[2], peaks, prof)
        return (kg.gather_windows_reference(packed, start, prof.patch_size,
                                            pack), start)

    def max_err(got, want) -> float:
        err = 0.0
        for a, b in zip(got, want):
            a, b = a.double(), b.double()
            same = (a == b)  # equal infinities count as exact
            d = torch.where(same, torch.zeros_like(a), (a - b).abs())
            err = max(err, float(torch.nan_to_num(d, nan=float("inf")).max()))
        return err

    def check_fields(ncc, area, gray, prof, what):
        got = fields_kernel(ncc, area, gray, prof)
        want = fields_plain(ncc, area, gray, prof)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"fields kernel != plain at {what}: "
                                 f"max abs err {err}")
        print(f"check fields {what}: exact (max_abs_err {err})", flush=True)
        return got, err

    def check_gather(packed, peaks, prof, pack, what):
        got = kg.gather_windows(packed, peaks, None, prof, pack=pack)
        want = gather_plain(packed, peaks, prof, pack)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"gather pack={pack} kernel != plain at "
                                 f"{what}: max abs err {err}")
        print(f"check gather pack={pack} {what}: exact (max_abs_err {err})",
              flush=True)
        return err

    @contextlib.contextmanager
    def plain_kernels():
        """Route the detector through the kernels' plain versions (for the
        plain-path comparison on the card)."""
        saved = (detector.fused_fields, detector.gather_windows_paired,
                 detector.gather_windows)

        def ff(ncc, area, gray, thr, open_k, prof):
            return kf.fused_fields_reference(ncc, area, gray, thr, open_k, prof)

        detector.fused_fields = ff
        detector.gather_windows_paired = (
            lambda packed, peaks, geom, prof: gather_plain(packed, peaks, prof, 2))
        detector.gather_windows = (
            lambda packed, peaks, geom, prof: gather_plain(packed, peaks, prof, 1))
        try:
            yield
        finally:
            (detector.fused_fields, detector.gather_windows_paired,
             detector.gather_windows) = saved

    def render(h, w, batch):
        scene = default_scene(h, w, device=dev)
        d = torch.zeros((batch, 65, 3), device=dev)
        d[:, :, 2] = -0.002 * torch.arange(batch, device=dev)[:, None]
        t = time.perf_counter()
        frames = render_frames(scene, d, chunk=64)
        torch.cuda.synchronize()
        print(f"render {batch}x{h}x{w}: {time.perf_counter() - t:.2f} s "
              f"[{card}]", flush=True)
        return scene, frames

    kernels = []

    def main_path(h, w, batch, label, run_cfg):
        """Counted run of the main path, checks, plain-path comparison and
        timings. Returns the phase record."""
        scene, frames = render(h, w, batch)
        cam = scene.cam
        rec: dict = {"shape": [batch, h, w]}
        # Warm-up (cuBLAS handles, allocator), not counted.
        ref = initialize(frames[0], run_cfg)
        process_frames(frames[:2], ref, cam, run_cfg)
        torch.cuda.synchronize()

        kf.fields_launches = 0
        kg.gather_launches = 0
        t = time.perf_counter()
        ref = initialize(frames[0], run_cfg)
        out = process_frames(frames, ref, cam, run_cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        launches = {"fields": kf.fields_launches, "gather": kg.gather_launches}
        rec["launches"] = launches
        print(f"{label}: main path ran in {first_s:.3f} s (first counted "
              f"run); launches {launches} [{card}]", flush=True)
        if min(launches.values()) <= 0:
            raise AssertionError(f"{label}: a kernel of the path was not "
                                 f"launched: {launches}")

        n_ref = int(ref.valid.sum())
        tracked = out.tracked.valid.sum(-1)
        tilt = out.contact.tilt_deg
        rec.update(ref_markers=n_ref, tracked_min=int(tracked.min()),
                   tracked_max=int(tracked.max()),
                   tilt_deg_last=float(tilt[-1]),
                   from_first_z_last_mm=float(
                       out.recon.from_first[-1, :, 2].mean()))
        print(f"{label}: reference markers {n_ref}; tracked per frame "
              f"min {int(tracked.min())} max {int(tracked.max())}; tilt "
              f"[{float(tilt.min()):.4f}, {float(tilt.max()):.4f}] deg; "
              f"mean dz at last frame {rec['from_first_z_last_mm']:.4f} mm",
              flush=True)
        if n_ref != 65 or int(tracked.min()) != 65:
            raise AssertionError(f"{label}: expected 65/65 markers in every "
                                 f"frame, got ref {n_ref}, tracked min "
                                 f"{int(tracked.min())}")
        if not bool(torch.isfinite(tilt).all()):
            raise AssertionError(f"{label}: non-finite tilt")
        for name in ("world", "from_first"):
            if not bool(torch.isfinite(getattr(out.recon, name)).all()):
                raise AssertionError(f"{label}: non-finite {name}")
        # The rendered drift is -0.002 mm/frame along z. At 640x480 the
        # depth-from-diameter reconstruction recovers it to ~1%; with the
        # high-res profile the JAX reference itself recovers only about a
        # third of a 0.094 mm step (-0.0342 mm on the same 1080x1920 frames,
        # as does the port), so there only the direction is checked.
        want_dz = -0.002 * (batch - 1)
        got_dz = rec["from_first_z_last_mm"]
        if h <= dcfg.low_res_max_rows:
            drift_ok = abs(got_dz - want_dz) <= 0.05 + 0.1 * abs(want_dz)
        else:
            drift_ok = got_dz < 0.0 or want_dz == 0.0
        if not drift_ok:
            raise AssertionError(f"{label}: last-frame mean dz {got_dz} mm "
                                 f"for a rendered {want_dz} mm")

        with plain_kernels():
            ref_p = initialize(frames[0], run_cfg)
            out_p = process_frames(frames, ref_p, cam, run_cfg)
            torch.cuda.synchronize()
        for name in out.detections._fields:
            a, b = getattr(out.detections, name), getattr(out_p.detections, name)
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: detections.{name} differ "
                                     "between the kernel and plain paths")
        if not torch.equal(out.contact.tilt_deg, out_p.contact.tilt_deg):
            raise AssertionError(f"{label}: tilt differs kernel vs plain")
        print(f"{label}: kernel path == plain path (detections, tilt)",
              flush=True)

        # Pipeline throughput: two batches per turn in the turns kernel,
        # plain, plain, kernel; fps is the batch over the median of a path's
        # four batch times.
        def run():
            process_frames(frames, ref, cam, run_cfg)

        def run_plain():
            with plain_kernels():
                process_frames(frames, ref, cam, run_cfg)

        s_k = _wall_s(run, 2)
        s_p = _wall_s(run_plain, 2)
        s_p += _wall_s(run_plain, 2)
        s_k += _wall_s(run, 2)
        fps_k = batch / statistics.median(s_k)
        fps_p = batch / statistics.median(s_p)
        rec.update(fps_kernel=fps_k, fps_plain=fps_p, s_kernel=s_k,
                   s_plain=s_p)
        print(f"{label}: pipeline fps kernel path {fps_k:.1f} (s "
              + ", ".join(f"{t:.4f}" for t in s_k) + f"), plain path "
              f"{fps_p:.1f} (s " + ", ".join(f"{t:.4f}" for t in s_p)
              + f") [{card}]", flush=True)

        # Stage breakdown of one kernel-path batch (host clock + sync).
        from vision_basedsensor_tpu_torch.analysis.force import \
            contact_state_sequence
        from vision_basedsensor_tpu_torch.reconstruct.depth import \
            reconstruct_positions
        from vision_basedsensor_tpu_torch.reconstruct.displacement import \
            displacement_scan
        from vision_basedsensor_tpu_torch.track.associate import associate
        det = out.detections
        stages = {
            "detect": lambda: detector.detect_markers(
                frames, run_cfg.detect, axis_scale=ref.axis_scale),
            "associate": lambda: associate(
                ref, det, run_cfg.track.min_marker_distance_px),
            "reconstruct_positions": lambda: reconstruct_positions(
                cam, out.tracked.xy, out.tracked.axes, out.tracked.valid,
                run_cfg.reconstruct),
            "displacement_scan": lambda: displacement_scan(
                out.recon.world, out.recon.seen, run_cfg.reconstruct),
            "contact_state": lambda: contact_state_sequence(
                out.recon, run_cfg.analysis),
        }
        rec["stages_ms"] = {k: 1e3 * statistics.median(_wall_s(fn, 2))
                            for k, fn in stages.items()}
        print(f"{label}: stages ms " + ", ".join(
            f"{k} {v:.2f}" for k, v in rec["stages_ms"].items())
            + f" [{card}]", flush=True)
        if args.profile:
            rec["profile"] = profile_batch(run, label,
                                           statistics.median(s_k))
        rec["frames"] = frames
        return rec

    def profile_batch(run, label, batch_s):
        """Device kernel time of one kernel-path batch by kernel name, and
        the device's busy share of the unprofiled batch time ``batch_s``."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
        busy, cur_end = 0.0, float("-inf")
        for a, b in sorted(spans):          # union of kernel intervals
            if b > cur_end:
                busy += b - max(a, cur_end)
                cur_end = b
        rows = sorted(((t, n, k) for k, (t, n) in by_name.items()),
                      reverse=True)
        print(f"{label}: profile: {len(spans)} kernels, device busy "
              f"{busy / 1e3:.2f} ms = {100 * busy / 1e6 / batch_s:.1f}% of the "
              f"unprofiled batch time {1e3 * batch_s:.2f} ms [{card}]",
              flush=True)
        for t, n, k in rows[:12]:
            print(f"  {t / 1e3:9.3f} ms {n:6d}x  {k[:90]}")
        return {"kernels": len(spans), "busy_ms": busy / 1e3,
                "batch_ms": 1e3 * batch_s,
                "top": [[k, n, t / 1e3] for t, n, k in rows[:40]]}

    # -- kernels vs plain at an unaligned shape ---------------------------------
    _, fr = render(437, 467, 4)
    ncc, area, gray = fields_inputs(fr, dcfg.low_res)
    (packed, cval, cidx), _ = check_fields(ncc, area, gray, dcfg.low_res,
                                           "4x437x467")
    peaks = select_peaks_from_cells(cval, cidx, 467, dcfg.max_candidates,
                                    float(dcfg.low_res.peak_window))
    for pack in (1, 2):
        check_gather(packed, peaks, dcfg.low_res, pack, "4x437x467")

    # -- main path: the two bench sizes and an odd K ---------------------------
    for label, h, w, batch, k in RUNS:
        run_cfg = dataclasses.replace(cfg, detect=dataclasses.replace(
            dcfg, max_candidates=k))
        prof = dcfg.low_res if h <= dcfg.low_res_max_rows else dcfg.high_res
        # The detector's rule (detect/detector.py): paired windows need an
        # even K and a patch that fits the 64-lane slot.
        path_pack = 2 if k % 2 == 0 and prof.patch_size <= 64 else 1
        rec = main_path(h, w, batch, label, run_cfg)
        frames = rec.pop("frames")
        what = f"{batch}x{h}x{w} K={k}"
        ncc, area, gray = fields_inputs(frames, prof)
        (packed, cval, cidx), f_err = check_fields(ncc, area, gray, prof, what)
        peaks = select_peaks_from_cells(cval, cidx, w, k,
                                        float(prof.peak_window))
        geom = cut_geometry(peaks)
        packs = (1, 2) if k % 2 == 0 else (1,)
        g_err = {p: check_gather(packed, peaks, prof, p, what) for p in packs}
        n_it = 10 if batch * h * w <= 2 ** 29 else 5
        f_ms = _event_ms(lambda: fields_kernel(ncc, area, gray, prof), n_it)
        f_plain = _event_ms(lambda: fields_plain(ncc, area, gray, prof), n_it)
        g_ms = _event_ms(lambda: kg.gather_windows(
            packed, peaks, geom, prof, pack=path_pack), n_it)
        g_plain = _event_ms(
            lambda: gather_plain(packed, peaks, prof, path_pack), n_it)
        rec["kernel_ms"] = {"fields": [f_ms, f_plain],
                            f"gather_pack{path_pack}": [g_ms, g_plain]}
        print(f"{label}: fields kernel {f_ms:.3f} ms vs plain {f_plain:.3f} "
              f"ms; gather pack={path_pack} {g_ms:.3f} vs {g_plain:.3f} ms "
              f"({what}) [{card}]", flush=True)
        records["phases"][label] = rec
        fields_name, fields_src = (
            ("fused_fields", "vision_basedsensor_tpu/ops/pallas/fields.py:225")
            if h * w <= 960 * 1280 else
            ("fused_fields_tiled",
             "vision_basedsensor_tpu/ops/pallas/fields.py:292"))
        gather_name, gather_src = (
            ("gather_windows_paired",
             "vision_basedsensor_tpu/ops/pallas/moments.py:429")
            if path_pack == 2 else
            ("gather_windows pack=1",
             "vision_basedsensor_tpu/ops/pallas/moments.py:358"))
        kernels.append(dict(
            name=f"{fields_name} {what}", route="cuda",
            source="vision_basedsensor_tpu_torch/csrc/fields.cu",
            replaces=fields_src, launches=rec["launches"]["fields"],
            max_abs_err=f_err, ms=f_ms, plain_ms=f_plain))
        kernels.append(dict(
            name=f"{gather_name} {what}", route="cuda",
            source="vision_basedsensor_tpu_torch/csrc/gather.cu",
            replaces=gather_src, launches=rec["launches"]["gather"],
            max_abs_err=g_err[path_pack], ms=g_ms, plain_ms=g_plain))
        del frames, ncc, area, gray, packed, cval, cidx, peaks, geom
        torch.cuda.empty_cache()

    records["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
