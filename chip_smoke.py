#!/usr/bin/env python3
"""The PyTorch + CUDA port (vision_basedsensor_tpu_torch) on an NVIDIA GPU:
its smoke run, and each hand-written kernel checked and timed alone.

    python3 chip_smoke.py [--out FILE]
    python3 chip_smoke.py --only fields|expand|window_sums|gather|scans
                          [--baseline OLD.cu ...] [--out FILE]
    python3 chip_smoke.py --only multi [--out FILE]

The bare run is the card's smoke run: it builds the kernels, runs every
``cuda_only`` test of ``tests/test_torch_*.py`` (``pytest --noconftest -m
cuda_only``: those files import no JAX), the main path at each of
MAIN_RUNS (``process_frames`` at the bench batches, its launches counted
from zero and checked by ``tests/torch_parity.py:check_main_path``, kernel
path against plain path) and each kernel phase once; it fails if a test
failed. What a user pays for (each benchmark cell's
frames/s, the device's idle share, every layer's device time) is measured
by ``vbs_bench/`` (``BENCHMARK.json``).

A kernel phase (``--only`` one of them) checks a kernel, and each
``--baseline`` (another version of its source with the same C entry, e.g.
``git show <rev>:vision_basedsensor_tpu_torch/csrc/gather.cu``, built into a
library of its own), against the kernel's plain version on the main path's
own inputs: frames rendered by the port's synth through the filters, the
fields kernel and the peak selection. It then times the versions with CUDA
events in turns (the baselines, the kernel twice, the baselines back)
beside the kernel's least time, the larger of its bytes over the card's
memory bandwidth and its float32 operations over the float32 peak
(``vbs_bench/roofline.py``), its plain version and, where there is one, a
library call:

  fields       the filter stencils (csrc/filters.cu) bit for bit against the
               GEMM path at UNSPLIT_BATCH (tests/torch_parity.py), timed
               beside it; the fields kernel (K1/K2, csrc/fields.cu) exact
               against fused_fields_reference at 4x437x467 and at each shape
               of ONLY_FIELDS;
  expand       the sorted-expand kernel (K8, csrc/expand_sorted.cu) int16
               equal to expand_sorted_reference on a TDELTA batch of EXPAND
               q70 frames, beside index_put_ and PyTorch's zero fill of the
               same output; the entries' spread over the output tiles;
  window_sums  the window-sums kernel (K5, and K6/K7 in its packed mode,
               csrc/window_sums.cu): slots 21-23 bit-equal, the rest within
               rtol 1e-5, atol 2e-2, at 4x437x467 and at each shape of
               ONLY_WS; at the packed shape also the split path the detector
               runs (paired gather + raw-moment basis sums);
  gather       the window-gather kernel (K3 pack=2, K4 pack=1, csrc/gather.cu)
               equal on every lane (an output filled with NaN first) for
               both packs at 4x437x467 and at each shape of ONLY_GATHER, in
               GATHER_ROUNDS rounds of turns, beside torch.gather and
               PyTorch's zero fill of the same output;
  scans        the displacement scan (csrc/displacement_scan.cu) and the
               sequential association (csrc/associate.cu) on the positions
               and detections of 1024 rendered 640x480 frames, at each shape
               of ONLY_SCAN and ONLY_ASSOC and resumed from the plain first
               half's carry; a --baseline goes to the one whose C entry it
               defines; timed behind a sleeping kernel so that the host's
               enqueue does not pace the card, in SCAN_ROUNDS rounds, each
               beside its dependency-chain floor, and the host time a call.

``--only multi`` times the data-parallel step over every visible card (two
shards in turn on one card) and the row-sharded meshes, each in turns with
one card's ``process_frames`` on the same frames; it checks only that each
step's ``seen`` equals one card's (``tests/test_torch_parallel_cuda.py``
holds them to the reference's tolerances).

The line before the last is the kernels' JSON record, with each main-path
run's launches in the smoke run; the last is
{"ok": true, "device": {...}}. A failed check raises, so the script exits
non-zero without that line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# --only fields: (rows, cols, batches), each batch the first frames of one
# render: the batches of the reference's bench sizes and of a stream chunk.
ONLY_FIELDS = ((480, 640, (1024, 64)), (1080, 1920, (48,)))
# --only expand: the ingest's batch of 640x480 frames (bench.py:122-159) and
# its JPEG quality.
EXPAND = (256, 70)
# --only window_sums: (rows, cols, batch, max_candidates, packed field). The
# unfused branch's call at 1080x1920; the packed mode (K6/K7) on the fused
# branch's packed field and cell peaks at 640x480.
ONLY_WS = ((1080, 1920, 48, 96, False), (480, 640, 1024, 96, True))
# --only gather: (rows, cols, batch, max_candidates, pack), the main path's
# gather calls: K4 at an odd K, K3 at the two bench sizes.
ONLY_GATHER = ((480, 640, 64, 97, 1), (1080, 1920, 48, 96, 2),
               (480, 640, 1024, 96, 2))
GATHER_ROUNDS = 3
# --only scans: the displacement scan's batches (x 65 markers): the bench
# batch, a stream chunk, the 1080x1920 batch, run-live's --batch, 16,
# indent's 13 frames, 8 and 4, tilt's 2, one request; the association's
# (batch, max_candidates): the batch, a stream chunk, run-live's --batch,
# an odd K.
ONLY_SCAN = (1024, 64, 48, 32, 16, 13, 8, 4, 2, 1)
ONLY_ASSOC = ((1024, 96), (64, 96), (32, 96), (64, 97))
SCAN_ROUNDS = 3
# Window-sum slots that kernel and plain version give bit-equal: lo, hi and
# the count of gated pixels.
WS_EXACT_SLOTS = (21, 22, 23)
# --only multi: the data-parallel batch (640x480) and the spatial meshes'
# 1080x1920 batch.
MULTI_BATCH = 1024
SPATIAL_BATCH = 48
# The smoke run's main path: (label, rows, cols, batch, max_candidates,
# backend). The reference's bench sizes (bench.py:99-119,476 and
# benchmarks/bench_highres.py) on the fused branch, the high-res frames on
# the unfused one ("xla"), and an odd K (the pack=1 gather).
MAIN_RUNS = (("640x480", 480, 640, 1024, 96, "auto"),
             ("1080x1920", 1080, 1920, 48, 96, "auto"),
             ("1080x1920 unfused", 1080, 1920, 48, 96, "xla"),
             ("640x480 K=97", 480, 640, 64, 97, "auto"))

# Each kernel's source and the JAX package's function it replaces.
SRC = {
    "fields": ("vision_basedsensor_tpu_torch/csrc/fields.cu",
               "vision_basedsensor_tpu/ops/pallas/fields.py:225",
               "vision_basedsensor_tpu/ops/pallas/fields.py:292"),
    "gather": ("vision_basedsensor_tpu_torch/csrc/gather.cu",
               "vision_basedsensor_tpu/ops/pallas/moments.py:429",
               "vision_basedsensor_tpu/ops/pallas/moments.py:358"),
    "window_sums": ("vision_basedsensor_tpu_torch/csrc/window_sums.cu",
                    "vision_basedsensor_tpu/ops/pallas/moments.py:439",
                    "vision_basedsensor_tpu/ops/pallas/moments.py:232"),
    "expand": ("vision_basedsensor_tpu_torch/csrc/expand_sorted.cu",
               "benchmarks/scatter_onehot_kernel.py:93"),
    "scan": ("vision_basedsensor_tpu_torch/csrc/displacement_scan.cu",
             "vision_basedsensor_tpu/reconstruct/displacement.py:82"),
    "associate": ("vision_basedsensor_tpu_torch/csrc/associate.cu",
                  "vision_basedsensor_tpu/track/associate.py:111"),
    "filters": ("vision_basedsensor_tpu_torch/csrc/filters.cu",
                "vision_basedsensor_tpu/core/imaging.py:104"),
}
# The two scans' dependency chains: the dependent instructions of one step
# on the path from its carry to the next step's carry, counted by reading
# the sources (not checked against SASS: recount them when a source
# changes), so the floor is printed, never recorded. Each is charged
# DEP_CYCLES, the latency between dependent instructions on the SM's FP32
# and integer pipes; sqrt's MUFU, shared loads, shuffles and the barrier
# take longer, so steps x chain x DEP_CYCLES at the card's top SM clock is
# a floor (PERF.md §6).
DEP_CYCLES = 4
# csrc/displacement_scan.cu: one instruction stands between a frame's carry
# and the next frame's, the walk's add `cum = cum + dnz` (the dnz loads are
# off the chain, the next 16 issued while 16 are added). `last` and `first`
# are no carry there: each frame finds its sightings in the tile's mask
# words, in parallel over frames; the tile's staging and mask words come
# before the walk, once a tile (1024 frames), and the per-frame work runs
# beside it, a chunk of 128 frames ahead.
SCAN_CHAIN = 1
# csrc/associate.cu's LANES: lanes a slot, whatever the slot count.
ASSOC_LANES = 4


# -- measuring ---------------------------------------------------------------

def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _sm_mhz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm), nan where
    nvidia-smi gives none."""
    out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    try:
        return float(out.stdout.strip())
    except ValueError:
        return math.nan


def _chain_note(steps: int, chain: float, mhz: float) -> str:
    """The printed dependency-chain floor of a scan: steps x chain x
    DEP_CYCLES at ``mhz``. Text only, never a record: the chain is counted
    from the source, not measured."""
    if math.isnan(mhz):
        return "dependency chain not computed (no clocks.max.sm)"
    ms = 1e-3 * steps * chain * DEP_CYCLES / mhz
    return (f"dependency chain {steps} steps x {chain:g} x {DEP_CYCLES} "
            f"cycles at {mhz:.0f} MHz = {ms:.5f} ms")


def _assoc_chain(valid_counts) -> float:
    """csrc/associate.cu (its fast path), a frame's dependent instructions,
    the mean over frames with ``valid_counts`` valid detections each (the
    walk reads only those): the first candidate's squared distance from
    the carry (a subtraction, a product, the sum) 3; the lane's compare
    chain over ceil(count / ASSOC_LANES) candidates, 2 each (the compare,
    the select of the least square); log2(ASSOC_LANES) shuffle rounds of
    (shuffle, 64-bit compare in 2, select) 4 each; the tie test (a product, a
    compare, a vote) 3; the pick's staged position, the root of the least
    square (4) and the key's pack (2) 7; the atomicMin's load and CAS, the
    barrier, the owner's load and compare 5; the carry's select 1."""
    lanes = ASSOC_LANES
    per = [19 + 4 * int(math.log2(lanes)) + 2 * -(-int(c) // lanes)
           for c in valid_counts]
    return sum(per) / max(len(per), 1)


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


def _device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls queued behind a
    sleeping kernel (100 us of SM cycles a call), so the host's enqueue
    does not pace the card: for kernels shorter than their launch's host
    cost. After one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(fn, reps: int = 200) -> float:
    """Host microseconds a call of ``fn`` (its enqueue), over ``reps``
    calls after a warm-up; the card catches up after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def _wall_s(fn, reps: int, devices=()) -> list[float]:
    """Host-clock seconds of each of ``reps`` calls of ``fn()``, each ending
    when the card and every one of ``devices`` is done."""
    import torch

    def sync():
        torch.cuda.synchronize()
        for d in devices:
            torch.cuda.synchronize(d)

    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return times


def in_turns(fns: dict, timer, rounds: int = 1) -> dict:
    """Each of ``fns`` (``{name: fn}``, the current kernel as "kernel")
    timed by ``timer(fn)`` in ``rounds`` rounds of turns: the others, the
    kernel twice, the others back. Returns ``{name: [ms, ...]}``."""
    others = [k for k in fns if k != "kernel"]
    order = [*others, "kernel", "kernel", *reversed(others)]
    out: dict = {k: [] for k in fns}
    for _ in range(rounds):
        for k in order:
            out[k].append(timer(fns[k]))
    return out


def _turns_text(turns: dict, bound_ms: float) -> str:
    return "; ".join(
        f"{who} min/median/max {min(t):.4f}/{statistics.median(t):.4f}/"
        f"{max(t):.4f} ms ({100 * bound_ms / statistics.median(t):.1f}% of "
        "bound)" for who, t in turns.items())


def _bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least ms for ``nbytes`` of memory traffic and ``nops`` float32
    operations (``vbs_bench/roofline.py``), and which of the two bounds
    it."""
    from vbs_bench import roofline
    t_b, t_o = roofline.bound_s(nbytes, 0.0), roofline.bound_s(0.0, nops)
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _distinct(b: int, h: int, w: int, ys, xs, keep) -> int:
    """Distinct in-image pixels ``(ys, xs)`` (broadcast to ``keep``'s
    shape, a leading frame axis) where ``keep`` holds."""
    import torch
    keep = keep & (xs < w) & (ys < h)
    flat = torch.where(keep, ys * w + xs, torch.full_like(keep, h * w,
                                                          dtype=torch.long))
    mask = torch.zeros((b, h * w + 1), dtype=torch.bool, device=keep.device)
    mask.scatter_(1, flat.reshape(b, -1), True)
    return int(mask[:, :h * w].sum())


def _max_err(got, want) -> float:
    """The largest absolute difference over pairs of tensors; equal
    infinities count as exact, a NaN as infinite."""
    import torch
    err = 0.0
    for a, b in zip(got, want):
        if a.numel() == 0:
            continue
        a, b = a.double(), b.double()
        d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
        err = max(err, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return err


def _record(kernels: list, name: str, kind: str, replaces: str, err: float,
            ms: float, plain_ms: float, bound_ms: float, **extra) -> None:
    kernels.append(dict(name=name, route="cuda", source=SRC[kind][0],
                        replaces=replaces, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms, **extra))


def _build_alt(src: str, entry: str):
    """Build one CUDA source with a plain C interface (another version of a
    kernel, with its C entry) into a library of its own; returns its
    function ``entry`` with the kernel library's signature of that name."""
    from vision_basedsensor_tpu_torch.ops.cuda import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = build.BUILD_DIR / f"alt_{tag}.{os.getpid()}.so"
    if not out.exists():
        log = build._run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                          str(out), os.path.abspath(src)])
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas ({os.path.basename(src)}): {line.strip()}")
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = list(build._SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return fn


# -- the main path's inputs ----------------------------------------------------

def _render(dev, card, h: int, w: int, batch: int):
    """``(scene, frames)``: ``batch`` frames of the port's synthetic dome at
    ``h`` x ``w`` on ``dev``, the markers drifting -0.002 mm a frame along
    z (``tests/torch_parity.py:render_drift``)."""
    import torch
    from torch_parity import render_drift
    t = time.perf_counter()
    scene, frames = render_drift(dev, h, w, batch)
    torch.cuda.synchronize()
    print(f"render {batch}x{h}x{w}: {time.perf_counter() - t:.2f} s [{card}]",
          flush=True)
    return scene, frames


def _profile(dcfg, h: int):
    return dcfg.low_res if h <= dcfg.low_res_max_rows else dcfg.high_res


def _fields_inputs(dcfg, frames, prof):
    """The fields kernel's inputs ``(ncc, area, gray)`` of ``frames``."""
    from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask
    from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian
    gray = frames.float().contiguous()
    area = dog_area_mask(gray, prof, dcfg.dog_offset).float()
    ncc = normxcorr_gaussian(area, prof.template_size, prof.template_sigma,
                             binary_input=True)
    return ncc, area, gray


def _fields(dcfg, ncc, area, gray, prof):
    from vision_basedsensor_tpu_torch.ops.cuda import fields as kf
    return kf.fused_fields(ncc, area, gray, dcfg.ncc_threshold,
                           dcfg.open_ksize, prof)


def _fused_peaks(dcfg, frames, prof, k: int):
    """The fused branch's packed field and cell peaks of ``frames``."""
    from vision_basedsensor_tpu_torch.ops.peaks import select_peaks_from_cells
    packed, cval, cidx = _fields(dcfg, *_fields_inputs(dcfg, frames, prof),
                                 prof)
    return packed, select_peaks_from_cells(cval, cidx, frames.shape[2], k,
                                           float(prof.peak_window))


def _unfused_inputs(dcfg, frames, prof, k: int):
    """The unfused branch's band, opened area, gray and peaks of ``frames``
    (detect/detector.py)."""
    from vision_basedsensor_tpu_torch.core.imaging import band_and_opening
    from vision_basedsensor_tpu_torch.ops.peaks import find_peaks
    ncc, area, gray = _fields_inputs(dcfg, frames, prof)
    band, area_open = band_and_opening(ncc, area, dcfg.ncc_threshold,
                                       prof.band_window, dcfg.open_ksize)
    peaks = find_peaks(ncc, dcfg.ncc_threshold, prof.peak_window, k,
                       float(prof.peak_window))
    return (band, area_open, gray), peaks


# -- --only fields -------------------------------------------------------------

def _filters(card, dcfg, frames, prof, what, kernels) -> dict:
    """The filter stencils (``filter_fields``) on ``frames``: two launches;
    gray, area and ncc bit for bit the GEMM path's at UNSPLIT_BATCH; timed
    behind a sleeping kernel beside the GEMM path and their bound
    (operations: 2 a tap's multiply-add over the eight passes, both blurs
    and the NCC's Gaussian and box along H and W; bytes: 13 a pixel, the
    uint8 frame read and gray, area and ncc written in float32)."""
    import torch
    from torch_parity import UNSPLIT_BATCH
    from vision_basedsensor_tpu_torch.ops.cuda import filters as kfil
    b, h, w = frames.shape
    reps = -(-UNSPLIT_BATCH[int(h > dcfg.low_res_max_rows)] // b)
    before = kfil.filters_launches
    got = kfil.filter_fields(frames, prof, dcfg.dog_offset)
    launches = kfil.filters_launches - before
    want = kfil.filter_fields_reference(frames.repeat(reps, 1, 1), prof,
                                        dcfg.dog_offset)
    for name, g, r in zip(("gray", "area", "ncc"), got, want):
        if not torch.equal(g, r[:b]):
            raise AssertionError(f"filters {what}: {name} differs from the "
                                 f"GEMM path in {int((g != r[:b]).sum())} "
                                 "pixels")
    if launches != 2:
        raise AssertionError(f"filters {what}: {launches} launches, "
                             "expected 2")
    del got, want
    n_it = 10 if b * h * w <= 2 ** 29 else 5
    ms = _device_ms(lambda: kfil.filter_fields(frames, prof, dcfg.dog_offset),
                    n_it)
    gemm_ms = _device_ms(lambda: kfil.filter_fields_reference(
        frames, prof, dcfg.dog_offset), n_it)
    taps = 2 * (prof.blur_small_ksize + prof.blur_large_ksize
                + 2 * prof.template_size)
    bound, by = _bound(13 * b * h * w, 2 * taps * b * h * w)
    torch.cuda.empty_cache()
    print(f"filters {what}: stencil kernels == GEMM path (gray, area, ncc); "
          f"{ms:.3f} ms vs GEMM path {gemm_ms:.3f} ms, bound {bound:.3f} ms "
          f"({by}), {100 * bound / ms:.1f}% of bound [{card}]", flush=True)
    _record(kernels, f"stencil_kernel {what}", "filters", SRC["filters"][1],
            0.0, ms, gemm_ms, bound, library_ms=gemm_ms)
    return {"ms": ms, "gemm_ms": gemm_ms, "bound_ms": bound}


def fields_phase(dev, card, cfg, baselines, kernels) -> dict:
    """The detector's front end alone: at 4x437x467 the fields kernel and
    each baseline exact against ``fused_fields_reference``; at each shape of
    ONLY_FIELDS the filter stencils (:func:`_filters`), then the fields
    kernel and each baseline exact and timed in turns."""
    import torch
    from vbs_bench import roofline
    from vision_basedsensor_tpu_torch.ops.cuda import build
    from vision_basedsensor_tpu_torch.ops.cuda import fields as kf
    dcfg = cfg.detect
    bases = {os.path.basename(s): _build_alt(s, "vbs_fused_fields")
             for s in baselines}

    def plain(ncc, area, gray, prof):
        return kf.fused_fields_reference(ncc, area, gray, dcfg.ncc_threshold,
                                         dcfg.open_ksize, prof)

    def versions(ncc, area, gray, prof):
        def base(fn):
            def run():
                b, h, w = ncc.shape
                packed = torch.empty_like(ncc)
                cval = torch.empty((b, -(-h // 8), -(-w // 8)), device=dev)
                cidx = torch.empty(cval.shape, dtype=torch.int32, device=dev)
                build.check(fn(
                    ncc.data_ptr(), area.data_ptr(), gray.data_ptr(),
                    packed.data_ptr(), cval.data_ptr(), cidx.data_ptr(), b, h,
                    w, dcfg.ncc_threshold, prof.band_window, prof.peak_window,
                    dcfg.open_ksize, kf.halo(prof, dcfg.open_ksize),
                    torch.cuda.current_stream(dev).cuda_stream),
                    "baseline fields launch")
                return packed, cval, cidx
            return run
        return {"kernel": lambda: _fields(dcfg, ncc, area, gray, prof),
                **{name: base(fn) for name, fn in bases.items()}}

    def check(ncc, area, gray, prof, what):
        fns = versions(ncc, area, gray, prof)
        want = plain(ncc, area, gray, prof)
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"fields {name} != plain at {what}: max "
                                     f"abs err {_max_err(got, want)}")
        print(f"check fields {what}: {', '.join(fns)} exact", flush=True)
        return fns

    lo = dcfg.low_res
    _, fr = _render(dev, card, 437, 467, 4)
    check(*_fields_inputs(dcfg, fr, lo), lo, "4x437x467")
    rec: dict = {}
    for h, w, batches in ONLY_FIELDS:
        prof = _profile(dcfg, h)
        _, frames = _render(dev, card, h, w, max(batches))
        for b in batches:
            what = f"{b}x{h}x{w}"
            rec[f"filters {what}"] = _filters(card, dcfg, frames[:b], prof,
                                              what, kernels)
            ncc, area, gray = _fields_inputs(dcfg, frames[:b], prof)
            turns = in_turns(check(ncc, area, gray, prof, what),
                             lambda f: _event_ms(f, 20))
            ms = statistics.mean(turns["kernel"])
            plain_ms = _event_ms(lambda: plain(ncc, area, gray, prof), 3)
            bound = 1e3 * roofline.fields_bound_s(
                b, h, w, prof.band_window, prof.peak_window, dcfg.open_ksize)
            rec[what] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                         "turns_ms": turns}
            print(f"fields {what}: kernel {ms:.4f} ms, " + ", ".join(
                f"{who} {statistics.mean(t):.4f} ms (turns {t})"
                for who, t in turns.items())
                + f"; plain {plain_ms:.3f} ms, bound {bound:.4f} ms, "
                f"{100 * bound / ms:.1f}% of bound [{card}]", flush=True)
            tiled = h * w > 960 * 1280
            _record(kernels, f"{'fused_fields_tiled' if tiled else 'fused_fields'}"
                    f" {what}", "fields", SRC["fields"][2 if tiled else 1],
                    0.0, ms, plain_ms, bound)
            del ncc, area, gray
            torch.cuda.empty_cache()
        del frames
    return rec


# -- --only expand -------------------------------------------------------------

def expand_phase(dev, card, cfg, baselines, kernels) -> dict:
    """K8 and each baseline int16-equal to the plain version on the TDELTA
    streams of EXPAND rendered q70 frames (as ``tdelta_to_device`` builds
    them), then timed in turns beside the plain version, ``index_put_``,
    PyTorch's zero fill of the same output and the bound (the dense int16
    output written once, each entry's int32 position and int16 value read
    once, one integer add an entry); and the entries' spread over the
    output tiles."""
    import torch
    from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
    from vision_basedsensor_tpu_torch.ops import jpeg as tj
    from vision_basedsensor_tpu_torch.ops.cuda import build
    from vision_basedsensor_tpu_torch.ops.cuda import expand as kx
    from vision_basedsensor_tpu_torch.ops.expand import expand_sorted_reference
    batch, quality = EXPAND
    _, frames = _render(dev, card, 480, 640, batch)
    u8 = frames.to(torch.uint8).cpu().numpy()   # truncation, as bench.py
    del frames
    ht = tj.MjpegBatchDecoder(device=dev).entropy_decode_tdelta(
        [encode_jpeg(f, quality) for f in u8])
    total = batch * ht.grid[0] * ht.grid[1] * ht.zmax
    pos, val = tj.tdelta_entries(torch.from_numpy(ht.ac).to(dev), ht.zmax)
    spos = tj.gap_positions(torch.from_numpy(ht.sgaps).to(dev))
    sval = torch.from_numpy(ht.sdeltas).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def base(fn):
        def run():
            out = torch.empty(total, dtype=torch.int16, device=dev)
            build.check(fn(pos.data_ptr(), val.data_ptr(), pos.numel(),
                           spos.data_ptr(), sval.data_ptr(), spos.numel(),
                           out.data_ptr(), total, stream),
                        "baseline expand_sorted launch")
            return out
        return run

    fns = {"kernel": lambda: kx.expand_sorted(pos, val, total, spos, sval),
           **{os.path.basename(s): base(_build_alt(s, "vbs_expand_sorted"))
              for s in baselines}}
    want = expand_sorted_reference(pos, val, total, spos, sval)
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"expand_sorted {name} != plain (max abs err "
                                 f"{float((got.int() - want.int()).abs().max())})")
    del got, want
    keep = (pos >= 0) & (pos < total)
    skeep = (spos >= 0) & (spos < total)
    lib_idx = (torch.cat([pos[keep], spos[skeep]]).long(),)
    lib_val = torch.cat([val[keep], sval[skeep]])
    out = torch.empty(total, dtype=torch.int16, device=dev)
    turns = in_turns(fns, lambda f: _event_ms(f, 20))
    ms = statistics.mean(turns["kernel"])
    plain_ms = _event_ms(lambda: expand_sorted_reference(
        pos, val, total, spos, sval), 20)
    lib_ms = _event_ms(lambda: torch.zeros(
        total, dtype=torch.int16, device=dev).index_put_(
            lib_idx, lib_val, accumulate=True), 20)
    zero_ms = _event_ms(out.zero_, 20)
    entries = pos.numel() + spos.numel()
    bound, by = _bound(2 * total + 6 * entries, entries)
    print(f"expand_sorted == plain on the TDELTA batch ({entries} entries -> "
          f"{total} int16; {', '.join(fns)} checked): " + ", ".join(
              f"{who} {statistics.mean(t):.4f} ms (turns {t})"
              for who, t in turns.items())
          + f"; plain {plain_ms:.4f} ms, index_put_ {lib_ms:.4f} ms, torch "
          f"zero_ of the output {zero_ms:.4f} ms, bound {bound:.4f} ms ({by}),"
          f" {100 * bound / ms:.1f}% of bound [{card}]", flush=True)
    # The entries' spread: over 4,096-slot tiles, in the first frame, and
    # in the heaviest block's run of tiles when G = 6 blocks an SM (the
    # kernel's occupancy at its 33 KB of shared memory) split the tiles by
    # length or, as csrc/expand_sorted.cu does, by weight (a tile = 256
    # entries).
    tile, weight_of_tile = 4096, 256
    tiles = -(-total // tile)
    per_tile = torch.bincount(pos[keep].long() // tile, minlength=tiles)
    g = 6 * torch.cuda.get_device_properties(dev).multi_processor_count
    q = torch.arange(tiles + 1, device=dev, dtype=torch.long)
    lb = torch.searchsorted(pos.long(), q * tile)
    d = (tiles * weight_of_tile + pos.numel()) * torch.arange(
        g + 1, device=dev) // g
    splits = {"length": torch.arange(g + 1, device=dev) * tiles // g,
              "weight": torch.searchsorted(q * weight_of_tile + lb,
                                           d).clamp(max=tiles)}
    spread = {"entries": int(keep.sum()), "tiles": tiles,
              "first_frame": int(((pos >= 0) & (pos < total // batch)).sum()),
              "max_per_tile": int(per_tile.max()),
              "empty_tiles": int((per_tile == 0).sum()), "blocks": g,
              "mean_per_block": int(keep.sum()) / g,
              "heaviest_block": {k: int((lb[v[1:]] - lb[v[:-1]]).max())
                                 for k, v in splits.items()}}
    print(f"expand_sorted entries: {spread}", flush=True)
    _record(kernels, f"expand_sorted tdelta {batch}x480x640", "expand",
            SRC["expand"][1], 0.0, ms, plain_ms, bound, library_ms=lib_ms,
            zero_ms=zero_ms)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "zero_ms": zero_ms, "bound_ms": bound, "turns_ms": turns,
            "spread": spread}


# -- --only window_sums --------------------------------------------------------

def _sums_close(got, want, valid, what) -> float:
    """Window sums against the plain version on valid peaks: lo (slot 21),
    hi (22) and the count of gated pixels (23) bit-equal, every other slot
    within the JAX tests' rtol 1e-5, atol 2e-2, with equal finite patterns.
    Prints the max abs error of each slot; returns the largest."""
    import torch
    a, b = got[valid].double(), want[valid].double()
    for s in WS_EXACT_SLOTS:
        if not torch.equal(a[:, s], b[:, s]):
            raise AssertionError(
                f"{what}: slot {s} not bit-equal to the plain version "
                f"({int((a[:, s] != b[:, s]).sum())} peaks differ)")
    fin = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), fin):
        raise AssertionError(f"{what}: finite patterns differ")
    d = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
    per_slot = (d.amax(0) if len(d) else torch.zeros(a.shape[1])).tolist()
    err = max(per_slot)
    if bool((d > 2e-2 + 1e-5 * torch.where(fin, b, 0.0).abs()).any()):
        raise AssertionError(f"{what}: kernel vs plain beyond rtol 1e-5 "
                             f"atol 2e-2 (max abs err {err}; by slot "
                             f"{per_slot})")
    print(f"check {what}: slots 21-23 bit-equal, the rest within rtol 1e-5 "
          f"atol 2e-2 on {len(b)} valid peaks (max abs err {err}); by slot: "
          + " ".join(f"{s}:{e:.3g}" for s, e in enumerate(per_slot)),
          flush=True)
    return err


def _window_stats(peaks, geom, prof, h: int, w: int) -> tuple[int, int]:
    """(gated pixel visits, distinct gated pixels) of the window sums."""
    from vision_basedsensor_tpu_torch.ops import moments as tm
    from vision_basedsensor_tpu_torch.ops.patches import patch_origins
    start = patch_origins(h, w, peaks.xy, prof.patch_size)
    gx, gy, _, _, keep = tm.patch_cut(start.float(), peaks, geom, prof)
    n = _distinct(peaks.xy.shape[0], h, w, gy.long(), gx.long(), keep)
    return int(keep.sum()), n


def _ws_bound_ms(stats, n_peaks: int, prof, packed: bool) -> float:
    """The window sums' least time (``vbs_bench/window_sums_bound.py``) on
    ``n_peaks`` peaks whose gated pixel visits and distinct gated pixels
    are ``stats``; nan for the packed field, which that file does not
    bound (it reads the field at 4 B a distinct gated pixel, not 12, and
    unpacks it in more operations a visit: ROADMAP Queue 3)."""
    from vbs_bench import window_sums_bound as wsb
    if packed:
        return math.nan
    return 1e3 * wsb.window_sums_bound_s(n_peaks, prof.patch_size,
                                         prof.soft_floor, *stats)


def _ws_measure(dev, card, what, fields, peaks, prof, versions,
                timed=True) -> dict:
    """Each version of the window-sums C entry (``{name: fn}``, the current
    kernel as "kernel") on ``fields`` (band, area, gray, or the packed field
    alone) with the wrapper's prepared arguments, against the plain version
    (:func:`_sums_close`), and the wrapper equal to its C entry; then, if
    ``timed``, the versions in turns beside the plain version, the wrapper,
    the bound and the gated pixels."""
    import torch
    from vision_basedsensor_tpu_torch.ops import moments as tm
    from vision_basedsensor_tpu_torch.ops.cuda import build
    from vision_basedsensor_tpu_torch.ops.cuda import window_sums as kw
    geom = tm.cut_geometry(peaks)
    packed = len(fields) == 1
    b, h, w = fields[0].shape
    if packed:
        def wrapper():
            return kw.window_sums_packed(fields[0], peaks, geom, prof)

        def plain():
            return kw.window_sums_packed_reference(fields[0], peaks, geom,
                                                   prof)
    else:
        def wrapper():
            return kw.window_sums(*fields, peaks, geom, prof)

        def plain():
            return tm.window_sums_xla(*fields, peaks, geom, prof)
    out, cargs, temps = kw._prepare(fields, peaks, geom, prof, what)
    stream = torch.cuda.current_stream(dev).cuda_stream

    # The default argument keeps the tensors cargs points into alive.
    def call(fn, o=out, _alive=(fields, temps)):
        build.check(fn(*cargs[:6], o.data_ptr(), *cargs[7:], stream),
                    f"window_sums {what} launch")
        return o

    want = plain()
    errs = {name: _sums_close(call(fn, torch.empty_like(out)), want,
                              peaks.valid, f"window_sums {name} {what}")
            for name, fn in versions.items()}
    got = wrapper()
    if not torch.equal(got, call(versions["kernel"], torch.empty_like(out))):
        raise AssertionError(f"window_sums {what}: the wrapper's output "
                             "differs from its C entry's")
    del got, want
    if not timed:
        return {"max_abs_err": errs}
    stats = _window_stats(peaks, geom, prof, h, w)
    bound = _ws_bound_ms(stats, peaks.valid.numel(), prof, packed)
    n_it = 20 if b * h * w <= 2 ** 28 else 10
    turns = in_turns(versions, lambda f: _event_ms(lambda: call(f), n_it))
    ms = statistics.mean(turns["kernel"])
    entry_ms = _event_ms(wrapper, n_it)
    plain_ms = _event_ms(plain, 3)
    print(f"window_sums {what}: kernel {ms:.4f} ms, " + ", ".join(
        f"{who} {statistics.mean(t):.4f} ms ("
        f"{100 * bound / statistics.mean(t):.1f}% of bound; turns {t})"
        for who, t in turns.items())
        + f"; wrapper with its patch-origin ops {entry_ms:.4f} ms; plain "
        f"{plain_ms:.3f} ms; bound {bound:.4f} ms, {100 * bound / ms:.1f}% of "
        f"bound{' (none for the packed field)' if packed else ''}; gated "
        f"visits {stats[0]}, distinct gated pixels {stats[1]} "
        f"({stats[0] / max(stats[1], 1):.3f} visits a pixel), "
        f"{stats[0] / peaks.valid.numel():.1f} a peak [{card}]", flush=True)
    return {"max_abs_err": errs, "ms": ms, "turns_ms": turns,
            "entry_ms": entry_ms, "plain_ms": plain_ms,
            "bound_ms": None if packed else bound,
            "visits": stats[0], "distinct": stats[1]}


def window_sums_phase(dev, card, cfg, baselines, kernels) -> dict:
    """The window-sums kernel and each baseline against the plain version
    at 4x437x467 on the unfused branch's inputs, then checked and timed at
    each shape of ONLY_WS; at the packed shape also the split path the
    detector runs on the same packed field and peaks."""
    import torch
    from vision_basedsensor_tpu_torch.ops import moments as tm
    from vision_basedsensor_tpu_torch.ops.cuda import build
    from vision_basedsensor_tpu_torch.ops.cuda import moments as kg
    dcfg = cfg.detect
    versions = {"kernel": build.library().vbs_window_sums,
                **{os.path.basename(s): _build_alt(s, "vbs_window_sums")
                   for s in baselines}}
    lo = dcfg.low_res
    _, fr = _render(dev, card, 437, 467, 4)
    fields, peaks = _unfused_inputs(dcfg, fr, lo, dcfg.max_candidates)
    rec: dict = {"4x437x467": _ws_measure(dev, card, "4x437x467", fields,
                                          peaks, lo, versions, timed=False)}
    del fr, fields, peaks
    for h, w, batch, k, packed in ONLY_WS:
        prof = _profile(dcfg, h)
        what = f"{batch}x{h}x{w} K={k}" + (" packed" if packed else "")
        _, frames = _render(dev, card, h, w, batch)
        if packed:      # as the fused branch gives them
            field, peaks = _fused_peaks(dcfg, frames, prof, k)
            fields = (field,)
        else:           # as the unfused branch gives them
            fields, peaks = _unfused_inputs(dcfg, frames, prof, k)
        del frames
        torch.cuda.empty_cache()
        r = rec[what] = _ws_measure(dev, card, what, fields, peaks, prof,
                                    versions)
        if packed:
            geom = tm.cut_geometry(peaks)

            def split():
                patches, pstart = kg.gather_windows_paired(field, peaks, geom,
                                                           prof)
                tm.moments_from_patches_paired_mxu(patches, pstart, peaks,
                                                   geom, prof, w)

            r["split_ms"] = _event_ms(split, 10)
            print(f"window sums {what}: the split path the detector runs "
                  f"(paired gather + raw-moment basis sums) "
                  f"{r['split_ms']:.3f} ms against the packed-field kernel's "
                  f"{r['ms']:.4f} ms [{card}]", flush=True)
        _record(kernels, f"{'window_sums_packed' if packed else 'window_sums'}"
                f" {what}", "window_sums",
                SRC["window_sums"][2 if packed else 1],
                r["max_abs_err"]["kernel"], r["ms"], r["plain_ms"],
                r["bound_ms"],
                visits_per_distinct=r["visits"] / max(r["distinct"], 1))
        del fields, peaks
        torch.cuda.empty_cache()
    return rec


# -- --only gather -------------------------------------------------------------

def _gather_measure(dev, card, what, packed, peaks, prof, pack, versions,
                    timed=True) -> dict:
    """Each version of the gather C entry (``{name: fn}``, the current
    kernel as "kernel") on the wrapper's prepared origins, and the wrapper,
    equal to the plain version on every lane of an output filled with NaN
    first; then, if ``timed``, the versions in GATHER_ROUNDS rounds of turns
    beside the bound, the plain version, the wrapper, ``torch.gather`` on
    the plain version's precomputed index (equal to the kernel on in-image
    lanes, the last column elsewhere) and PyTorch's zero fill of the same
    output."""
    import torch
    from vbs_bench import roofline
    from vision_basedsensor_tpu_torch.ops.cuda import build
    from vision_basedsensor_tpu_torch.ops.cuda import moments as kg
    b, h, w = packed.shape
    k, p = peaks.xy.shape[-2], prof.patch_size
    start = kg._prep(h, w, peaks, prof)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn, out):
        build.check(fn(packed.data_ptr(), start.data_ptr(), out.data_ptr(),
                       b, h, w, k, p, pack, stream),
                    f"gather {what} pack={pack} launch")
        return out

    want = kg.gather_windows_reference(packed, start, p, pack)
    for name, fn in versions.items():
        got = call(fn, torch.full_like(want, float("nan")))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather {name} pack={pack} != plain at "
                                 f"{what}: max abs err "
                                 f"{_max_err([got], [want])}")
    got, gstart = kg.gather_windows(packed, peaks, None, prof, pack=pack)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(gstart, start)):
        raise AssertionError(f"gather wrapper pack={pack} != plain at {what}")
    print(f"check gather pack={pack} {what}: {', '.join(versions)} and the "
          f"wrapper equal to the plain version on all {want.numel()} lanes, "
          f"{int((want == 0).sum())} of them 0", flush=True)
    del got, gstart
    if not timed:
        return {}
    out = torch.empty_like(want)
    turns = in_turns({n: (lambda f=fn: call(f, out))
                      for n, fn in versions.items()},
                     lambda f: _event_ms(f, 20), GATHER_ROUNDS)
    flat = packed.reshape(b, h * w)
    idx = kg.gather_index(start, w, p, pack)[0].flatten(1)
    lib_ms = _event_ms(lambda: torch.gather(flat, 1, idx), 20)
    zero_ms = _event_ms(out.zero_, 20)
    entry_ms = _event_ms(lambda: kg.gather_windows(packed, peaks, None, prof,
                                                   pack=pack), 20)
    plain_ms = _event_ms(lambda: kg.gather_windows_reference(packed, start, p,
                                                             pack), 3)
    # The distinct in-image pixels of the windows: a window row's 64
    # columns a slot at pack=2, its 128 at pack=1.
    r = torch.arange(p, device=dev)
    c = torch.arange(64 if pack == 2 else 128, device=dev)
    ys = start[..., 1, None, None].long() + r[:, None]
    xs = start[..., 0, None, None].long() + c[None, :]
    keep = torch.ones((b, k, p, len(c)), dtype=torch.bool, device=dev)
    bound = 1e3 * roofline.gather_bound_s(b, k, p, pack,
                                          _distinct(b, h, w, ys, xs, keep))
    ms = statistics.median(turns["kernel"])
    written = want.numel() * 4
    print(f"gather pack={pack} {what}: kernel median {ms:.4f} ms "
          f"({100 * bound / ms:.1f}% of bound, {written / ms / 1e9:.3f} TB/s "
          f"written); {_turns_text(turns, bound)}; wrapper with its "
          f"patch-origin ops {entry_ms:.4f} ms; plain {plain_ms:.3f} ms; "
          f"torch.gather on the plain index {lib_ms:.4f} ms; torch zero_ of "
          f"the output {zero_ms:.4f} ms ({written / zero_ms / 1e9:.3f} TB/s);"
          f" bound {bound:.4f} ms ({written} B written) [{card}]", flush=True)
    return {"ms": ms, "turns_ms": turns, "entry_ms": entry_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "zero_ms": zero_ms,
            "bound_ms": bound, "written_bytes": written}


def gather_phase(dev, card, cfg, baselines, kernels) -> dict:
    """The gather kernel and each baseline against the plain version at
    4x437x467 for both packs, then checked and timed at each shape of
    ONLY_GATHER on the main path's packed field and cell peaks."""
    import torch
    from vision_basedsensor_tpu_torch.ops.cuda import build
    dcfg = cfg.detect
    versions = {"kernel": build.library().vbs_gather_windows,
                **{os.path.basename(s): _build_alt(s, "vbs_gather_windows")
                   for s in baselines}}
    lo = dcfg.low_res
    _, fr = _render(dev, card, 437, 467, 4)
    packed, peaks = _fused_peaks(dcfg, fr, lo, dcfg.max_candidates)
    for pack in (1, 2):
        _gather_measure(dev, card, "4x437x467", packed, peaks, lo, pack,
                        versions, timed=False)
    del fr, packed, peaks
    rec: dict = {}
    for h, w, batch, k, pack in ONLY_GATHER:
        prof = _profile(dcfg, h)
        what = f"{batch}x{h}x{w} K={k}"
        _, frames = _render(dev, card, h, w, batch)
        packed, peaks = _fused_peaks(dcfg, frames, prof, k)
        del frames
        torch.cuda.empty_cache()
        r = rec[f"{what} pack={pack}"] = _gather_measure(
            dev, card, what, packed, peaks, prof, pack, versions)
        _record(kernels, f"{'gather_windows_paired' if pack == 2 else 'gather_windows pack=1'}"
                f" {what}", "gather", SRC["gather"][1 if pack == 2 else 2],
                0.0, r["ms"], r["plain_ms"], r["bound_ms"],
                library_ms=r["library_ms"], zero_ms=r["zero_ms"])
        del packed, peaks
        torch.cuda.empty_cache()
    return rec


# -- --only scans --------------------------------------------------------------

def _scan_check(got, gfin, want, wfin, what) -> float:
    """A scan version's outputs and final carry against the plain
    version's: flags and copied values bit-equal, norms within 1e-6,
    cum_path and cum within 1e-5. Returns the max abs error."""
    import torch
    tol = {"step_norm": 1e-6, "from_first_norm": 1e-6, "cum_path": 1e-5,
           "cum": 1e-5}
    e = 0.0
    for k, a, w in [*zip(want._fields[2:], got, want[2:]),
                    *((k, gfin[k], wfin[k]) for k in gfin)]:
        d = _max_err([a], [w]) if k in tol else 0.0
        if a.shape != w.shape or (d > tol[k] if k in tol
                                  else not torch.equal(a, w)):
            raise AssertionError(f"displacement_scan {what}: {k} differs "
                                 "from the plain version")
        e = max(e, d)
    return e


def _assoc_check(got, glast, want, wlast, what) -> None:
    """An association version's outputs and carry bit-equal to the plain
    version's."""
    import torch
    for name, a, w in zip(("xy", "axes", "angle", "valid", "last"),
                          (*got, glast),
                          (want.xy, want.axes, want.angle, want.valid,
                           wlast)):
        if a.shape != w.shape or not torch.equal(a, w):
            raise AssertionError(f"associate_sequential {what}: {name} "
                                 "differs from the plain version")


def _scan_baselines(baselines, lib):
    """The scan and association versions: the current kernels and each
    baseline, which goes to the one whose C entry it defines (one nvcc a
    baseline, started together)."""
    scan_v = {"kernel": lib.vbs_displacement_scan}
    assoc_v = {"kernel": lib.vbs_associate_sequential}
    alts = []
    for src in baselines:
        text = Path(src).read_text()
        if "vbs_displacement_scan(" in text:
            alts.append((scan_v, src, "vbs_displacement_scan"))
        elif "vbs_associate_sequential(" in text:
            alts.append((assoc_v, src, "vbs_associate_sequential"))
        else:
            raise SystemExit(f"chip_smoke: --baseline {src} defines neither "
                             "scan entry")
    with ThreadPoolExecutor(max(len(alts), 1)) as pool:
        built = list(pool.map(lambda a: _build_alt(a[1], a[2]), alts))
    for (versions, src, _), fn in zip(alts, built):
        versions[os.path.basename(src)] = fn
    return scan_v, assoc_v


def scans_phase(dev, card, cfg, baselines, kernels) -> dict:
    """Each version of the scan and association kernels against its plain
    version at every shape of ONLY_SCAN and ONLY_ASSOC on the positions and
    detections of rendered 640x480 frames (and resumed from the plain first
    half's carry at the largest), then timed in turns beside its bound
    (the scan: world and seen read, 13 B a marker-frame, the six outputs
    written, 37 B, the carry, 30 B a marker, and 20 operations a
    marker-frame; the association: the detections read, 21 B each, the
    table, 9 B a slot, the outputs, 21 B a slot-frame, the carry, 8 B a
    slot, and 7 operations a slot and detection plus 1 a slot pair, a
    frame), its plain version and its dependency-chain floor; and the
    host time a call of each version's argument preparation plus its C
    entry, and of the wrapper."""
    import dataclasses

    import torch
    from vision_basedsensor_tpu_torch.ops.cuda import build
    from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
    from vision_basedsensor_tpu_torch.pipeline import (initialize,
                                                       process_frames)
    from vision_basedsensor_tpu_torch.reconstruct.displacement import \
        displacement_scan_reference
    from vision_basedsensor_tpu_torch.track.associate import \
        associate_sequential_reference
    lib = build.library()
    scan_v, assoc_v = _scan_baselines(baselines, lib)
    res = subprocess.run([os.path.join(os.path.dirname(build._nvcc()),
                                       "cuobjdump"), "-res-usage",
                          str(build.library_path())],
                         capture_output=True, text=True)
    on = False
    for line in res.stdout.splitlines():   # the two kernels' resources
        if "Function" in line:
            on = "displacement_scan" in line or "associate" in line
        if on and "REG" in line:
            print(f"  cuobjdump -res-usage: {line.strip()}")
    dcfg, rcfg = cfg.detect, cfg.reconstruct
    max_step = rcfg.max_step_displacement_mm
    gate = cfg.track.min_marker_distance_px
    stream = torch.cuda.current_stream().cuda_stream
    mhz = _sm_mhz()
    spin = 20_000_000
    spin_ms = _event_ms(lambda: torch.cuda._sleep(spin), 3)
    print(f"scans: SM clock {spin / spin_ms / 1e3:.0f} MHz (a spin of {spin} "
          f"cycles took {spin_ms:.3f} ms) [{card}]", flush=True)
    frames_n = max(*ONLY_SCAN, *(b for b, _ in ONLY_ASSOC))
    scene, frames = _render(dev, card, 480, 640, frames_n)
    ref = initialize(frames[0], cfg)
    out = process_frames(frames, ref, scene.cam, cfg)
    world = out.recon.world.contiguous()
    seen = out.recon.seen.contiguous()
    dets = {dcfg.max_candidates: out.detections}
    for b, k in ONLY_ASSOC:
        if k not in dets:
            kcfg = dataclasses.replace(cfg, detect=dataclasses.replace(
                dcfg, max_candidates=k))
            dets[k] = process_frames(frames[:b], ref, scene.cam,
                                     kcfg).detections
    del frames, out
    torch.cuda.empty_cache()
    n = world.shape[1]
    print(f"scans: versions {', '.join(scan_v)} and {', '.join(assoc_v)}; "
          f"positions and detections of {frames_n} rendered 640x480 frames "
          f"[{card}]", flush=True)

    def line(turns, b, chain):
        floor_ns = 1e3 * chain * DEP_CYCLES / mhz
        return "; ".join(
            f"{who} min/median/max {min(t):.5f}/{statistics.median(t):.5f}/"
            f"{max(t):.5f} ms ({1e6 * statistics.median(t) / b:.1f} ns a "
            f"frame, {1e6 * statistics.median(t) / b / floor_ns:.1f}x the "
            "chain floor)" for who, t in turns.items())

    rec: dict = {"scan": {}, "associate": {}}
    for b in ONLY_SCAN:
        w, sx = world[:b], seen[:b]
        cases = [("fresh", w, sx, None)]
        if b == max(ONLY_SCAN):
            _, c = displacement_scan_reference(w[:b // 2], sx[:b // 2], rcfg,
                                               None, True)
            cases.append(("resumed", w[b // 2:], sx[b // 2:], c))
        err = 0.0
        for case, wx, sxx, c in cases:
            want, wfin = displacement_scan_reference(wx, sxx, rcfg, c, True)
            for name, entry in scan_v.items():
                a, got, gfin = kscan.scan_args(wx, sxx, max_step, c)
                build.check(entry(*a, stream), f"scan {name} launch")
                torch.cuda.synchronize()
                e = _scan_check(got, gfin, want, wfin,
                                f"{name} {b}x{n} {case}")
                err = max(err, e) if name == "kernel" else err
            print(f"check displacement_scan {b}x{n} {case}: "
                  f"{', '.join(scan_v)} flags and copies equal, norms and cum "
                  f"within 1e-6/1e-5 (kernel max abs err {err})", flush=True)
        prep = kscan.scan_args(w, sx, max_step, None)
        turns = in_turns({who: (lambda e=e, who=who: build.check(
            e(*prep[0], stream), f"scan {who} launch"))
            for who, e in scan_v.items()}, lambda f: _device_ms(f, 50),
            SCAN_ROUNDS)
        wrap_us = {who: _host_us(lambda e=e, who=who: build.check(
            e(*kscan.scan_args(w, sx, max_step, None)[0], stream),
            f"scan {who} launch")) for who, e in scan_v.items()}
        wrap_us["wrapper"] = _host_us(lambda: kscan.displacement_scan(
            w, sx, max_step, None))
        plain_ms = _event_ms(lambda: displacement_scan_reference(w, sx, rcfg),
                             1)
        bound, by = _bound(b * n * (13 + 37) + 30 * n, 20 * b * n)
        ms = statistics.median(turns["kernel"])
        print(f"displacement_scan {b}x{n}: {line(turns, b, SCAN_CHAIN)}; "
              f"plain {plain_ms:.3f} ms; bound {bound:.5f} ms ({by}); "
              f"{_chain_note(b, SCAN_CHAIN, mhz)}; host us a call (scan_args "
              "+ C entry; the wrapper): " + ", ".join(
                  f"{who} {u:.1f}" for who, u in wrap_us.items())
              + f" [{card}]", flush=True)
        rec["scan"][f"{b}x{n}"] = {"turns_ms": turns, "plain_ms": plain_ms,
                                  "bound_ms": bound, "max_abs_err": err,
                                  "wrapper_host_us": wrap_us}
        _record(kernels, f"displacement_scan {b}x{n}", "scan", SRC["scan"][1],
                err, ms, plain_ms, bound, baseline_ms={
                    who: statistics.median(t) for who, t in turns.items()
                    if who != "kernel"})
        del prep

    for b, k in ONLY_ASSOC:
        det = type(dets[k])(*(x[:b] for x in dets[k][:5]))
        cases = [("fresh", det, None)]
        if b == max(x for x, _ in ONLY_ASSOC):
            half = type(det)(*(x[:b // 2] for x in det[:5]))
            _, c = associate_sequential_reference(ref, half, gate, None, True)
            cases.append(("resumed", type(det)(*(x[b // 2:]
                                                 for x in det[:5])), c))
        for case, d, c in cases:
            want, wlast = associate_sequential_reference(ref, d, gate, c, True)
            for name, entry in assoc_v.items():
                a, got, glast = kscan.assoc_args(ref, d, gate, c)
                build.check(entry(*a, stream), f"associate {name} launch")
                torch.cuda.synchronize()
                _assoc_check(got, glast, want, wlast,
                             f"{name} {b}x{n} K={k} {case}")
            print(f"check associate_sequential {b}x{n} K={k} {case}: "
                  f"{', '.join(assoc_v)} equal to the plain version "
                  f"({int(want.valid.sum())} of {want.valid.numel()} slots "
                  "valid)", flush=True)
        prep = kscan.assoc_args(ref, det, gate, None)
        turns = in_turns({who: (lambda e=e, who=who: build.check(
            e(*prep[0], stream), f"associate {who} launch"))
            for who, e in assoc_v.items()},
            lambda f: _device_ms(f, 10 if b > 64 else 30), SCAN_ROUNDS)
        wrap_us = {who: _host_us(lambda e=e, who=who: build.check(
            e(*kscan.assoc_args(ref, det, gate, None)[0], stream),
            f"associate {who} launch")) for who, e in assoc_v.items()}
        wrap_us["wrapper"] = _host_us(lambda: kscan.associate_sequential(
            ref, det, gate, None))
        plain_ms = _event_ms(lambda: associate_sequential_reference(
            ref, det, gate), 1)
        bound, by = _bound(b * k * 21 + n * 9 + b * n * 21 + 8 * n,
                           b * (7 * n * k + n * n))
        cnt = det.valid.sum(1).tolist()
        chain = _assoc_chain(cnt)
        ms = statistics.median(turns["kernel"])
        print(f"associate_sequential {b}x{n} K={k} ({sum(cnt) / b:.1f} valid "
              f"detections a frame): {line(turns, b, chain)}; plain "
              f"{plain_ms:.3f} ms; bound {bound:.5f} ms ({by}); "
              f"{_chain_note(b, chain, mhz)}; host us a call (assoc_args + C "
              "entry; the wrapper): " + ", ".join(
                  f"{who} {u:.1f}" for who, u in wrap_us.items())
              + f" [{card}]", flush=True)
        rec["associate"][f"{b}x{n} K={k}"] = {
            "turns_ms": turns, "plain_ms": plain_ms, "bound_ms": bound,
            "chain": chain, "wrapper_host_us": wrap_us}
        _record(kernels, f"associate_sequential {b}x{n} K={k}", "associate",
                SRC["associate"][1], 0.0, ms, plain_ms, bound, baseline_ms={
                    who: statistics.median(t) for who, t in turns.items()
                    if who != "kernel"})
        del prep
    return rec


# -- --only multi --------------------------------------------------------------

def _fps_in_turns(label, batch, single, sharded, devices, card) -> dict:
    """Frames a second of one card's ``process_frames`` and of a sharded
    step on the same frames: two batches a turn, in the turns one card,
    sharded, sharded, one card; the batch over the median of four."""
    s_1 = _wall_s(single, 2, devices)
    s_n = _wall_s(sharded, 2, devices)
    s_n += _wall_s(sharded, 2, devices)
    s_1 += _wall_s(single, 2, devices)
    rec = {"fps_single": batch / statistics.median(s_1),
           "fps_sharded": batch / statistics.median(s_n),
           "s_single": s_1, "s_sharded": s_n}
    print(f"multi {label}: fps sharded {rec['fps_sharded']:.1f} (s "
          + ", ".join(f"{t:.4f}" for t in s_n) + f"), one card "
          f"{rec['fps_single']:.1f} (s " + ", ".join(f"{t:.4f}" for t in s_1)
          + f") [{card}]", flush=True)
    return rec


def _same_seen(out, base, what) -> None:
    import torch
    if not torch.equal(out.recon.seen, base.recon.seen):
        raise AssertionError(f"multi {what}: seen differs from one card's")


def multi_phase(dev, card, cfg, baselines, kernels) -> dict:
    """The data-parallel step over every visible card (two shards in turn on
    one card) at 640x480 B=MULTI_BATCH, and the row-sharded meshes at
    1080x1920 B=SPATIAL_BATCH (on one card [cuda:0] * 2 at spatial=2 and
    [cuda:0] * 4 as 2 x 2; on several, every card at spatial=2 and, with
    four, at spatial=4) against one card's ``process_frames``
    (``backend="xla"`` for the meshes), fps in turns."""
    import dataclasses

    import torch
    from vision_basedsensor_tpu_torch.parallel import (make_mesh,
                                                       make_sharded_pipeline,
                                                       shard_frames)
    from vision_basedsensor_tpu_torch.pipeline import (initialize,
                                                       process_frames)
    n_dev = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(n_dev)]
    rec: dict = {"device_count": n_dev}

    mesh = make_mesh(devs) if n_dev >= 2 else make_mesh([dev, dev])
    scene, frames = _render(dev, card, 480, 640, MULTI_BATCH)
    ref = initialize(frames[0], cfg)
    step = make_sharded_pipeline(mesh, scene.cam, cfg)
    _same_seen(step(shard_frames(frames, mesh), ref),
               process_frames(frames, ref, scene.cam, cfg), "data")
    rec["data"] = _fps_in_turns(
        f"data-parallel {MULTI_BATCH}x480x640 over {mesh.devices}",
        MULTI_BATCH, lambda: process_frames(frames, ref, scene.cam, cfg),
        lambda: step(shard_frames(frames, mesh), ref), devs, card)
    del scene, frames, ref, step
    torch.cuda.empty_cache()

    if n_dev >= 2:
        meshes = [make_mesh(devs, spatial=2)]
        if n_dev == 4:
            meshes.append(make_mesh(devs, spatial=4))
    else:
        meshes = [make_mesh([dev] * 2, spatial=2),
                  make_mesh([dev] * 4, spatial=2)]
    xcfg = dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, backend="xla"))
    scene, frames = _render(dev, card, 1080, 1920, SPATIAL_BATCH)
    ref = initialize(frames[0], xcfg)
    for mesh in meshes:
        key = f"{len(mesh.grid)}x{mesh.spatial}"
        step = make_sharded_pipeline(mesh, scene.cam, cfg)
        _same_seen(step(shard_frames(frames, mesh), ref),
                   process_frames(frames, ref, scene.cam, xcfg), key)
        rec[f"spatial {key}"] = _fps_in_turns(
            f"spatial {key} {SPATIAL_BATCH}x1080x1920", SPATIAL_BATCH,
            lambda: process_frames(frames, ref, scene.cam, xcfg),
            lambda: step(shard_frames(frames, mesh), ref), devs, card)
    return rec


# -- the main path -------------------------------------------------------------

def main_path_phase(dev, card) -> dict:
    """``process_frames`` at each of MAIN_RUNS on frames drifting -0.002 mm
    a frame along z, held by ``torch_parity.check_main_path`` to exactly
    its branch's kernel launches (counted from zero just before the call),
    65/65 markers, the drift and the kernels' plain versions. Returns each
    run's shape and launches."""
    import torch
    from torch_parity import check_main_path
    rec = {}
    for label, h, w, b, k, backend in MAIN_RUNS:
        t = time.perf_counter()
        launches = check_main_path(dev, h, w, b, k, backend)
        rec[label] = {"shape": [b, h, w], "max_candidates": k,
                      "backend": backend, "launches": launches}
        print(f"main path {label} B={b} K={k} backend={backend}: launches "
              f"{launches}; 65/65 markers, the drift, kernel path against "
              f"plain path held ({time.perf_counter() - t:.1f} s with the "
              f"render and the plain path) [{card}]", flush=True)
        torch.cuda.empty_cache()
    return rec


# -- the runs ------------------------------------------------------------------

PHASES = {"fields": fields_phase, "expand": expand_phase,
          "window_sums": window_sums_phase, "gather": gather_phase,
          "scans": scans_phase, "multi": multi_phase}
KERNEL_PHASES = ("fields", "expand", "window_sums", "gather", "scans")


def card_test_files() -> list[str]:
    """The test files that hold ``cuda_only`` tests."""
    return sorted(str(p.relative_to(ROOT))
                  for p in (ROOT / "tests").glob("test_torch_*.py")
                  if "pytest.mark.cuda_only" in p.read_text())


def run(only: str | None, baselines: list[str], out: str | None) -> None:
    """Build the kernels, then the smoke run (``only`` None) or one phase;
    print the kernels' record and the result line."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this needs an NVIDIA GPU")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import vision_basedsensor_tpu_torch  # noqa: F401  (sets the TF32 flags)
    threads = torch.get_num_threads()
    import torch_parity  # noqa: F401  (its shared card helpers)
    torch.set_num_threads(threads)      # it keeps the CPU suite's workers to 1
    from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                     ReconstructConfig)
    from vision_basedsensor_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    build.library()
    records: dict = {"card": card, "build_s": time.perf_counter() - t0,
                     "phases": {}}
    print(f"build: {records['build_s']:.2f} s (nvcc {build.build_seconds}) -> "
          f"{build.library_path().name} [{card}]", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    kernels: list = []

    failed = 0
    if only is None:
        files = card_test_files()
        failed = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-p",
             "no:cacheprovider", "-m", "cuda_only", "-q", *files],
            cwd=ROOT).returncode
        records["card_tests"] = {"files": files, "exit": failed}
        records["main_path"] = main_path_phase(dev, card)
        for name in KERNEL_PHASES:
            records["phases"][name] = PHASES[name](dev, card, cfg, (),
                                                   kernels)
    else:
        records["phases"][only] = PHASES[only](dev, card, cfg, baselines,
                                               kernels)
    records["kernels"] = kernels
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(records, f, indent=1)
    if failed:
        raise SystemExit(f"chip_smoke: the card tests failed (pytest exit "
                         f"{failed})")
    print(json.dumps({"kernels": kernels, "launches": {
        label: r["launches"] for label, r in records.get("main_path",
                                                         {}).items()}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the records here")
    ap.add_argument("--only", choices=tuple(PHASES), default=None,
                    help="check and time one kernel alone, or time only the "
                         "data-parallel step and the spatial meshes")
    ap.add_argument("--baseline", action="append", default=[],
                    help="with --only a kernel: another version of that "
                         "kernel's source to check and time in turns with "
                         "the current kernel (repeatable)")
    args = ap.parse_args(argv)
    if args.baseline and args.only in (None, "multi"):
        ap.error("--baseline needs --only fields, expand, window_sums, "
                 "gather or scans")
    run(args.only, args.baseline, args.out)


if __name__ == "__main__":
    main()
