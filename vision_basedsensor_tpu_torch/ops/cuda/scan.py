"""The reference's two ``lax.scan``s over frames as one kernel launch each.

``displacement_scan`` launches ``csrc/displacement_scan.cu`` (the scan of
``vision_basedsensor_tpu/reconstruct/displacement.py:82``);
``associate_sequential`` launches ``csrc/associate.cu`` (the scan of
``vision_basedsensor_tpu/track/associate.py:111``). Neither has a Pallas
kernel in the reference. Their plain versions are
``reconstruct/displacement.py:displacement_scan_reference`` and
``track/associate.py:associate_sequential_reference``; the public functions
there dispatch: a CPU tensor takes the plain version, a CUDA tensor comes
here. These wrappers take CUDA tensors only: they check device, dtype,
shape and contiguity, launch, and raise on anything else (no fallback).
Outputs and the final carry are new tensors; the given carry is only read.
"""
from __future__ import annotations

import torch

from vision_basedsensor_tpu_torch.ops.cuda import build

MAX_SLOTS = 128        # markers the association kernel takes (csrc/associate.cu)
MAX_DETECTIONS = 1024  # detections per frame it takes

# Kernel launches since the last reset (chip_smoke.py reads and resets them).
scan_launches = 0
assoc_launches = 0


def _check(x: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
           dev: torch.device) -> None:
    if x.device != dev:
        raise ValueError(f"{what} must lie on {dev}, got {x.device}")
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous {dtype} {shape}, got "
                         f"{x.dtype} {tuple(x.shape)}"
                         f"{'' if x.is_contiguous() else ' (strided)'}")


def _cuda_device(x: torch.Tensor, fn: str) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: the kernel takes CUDA tensors, got "
                         f"{x.device} (the plain version serves the CPU)")
    return x.device


def scan_args(world: torch.Tensor, seen: torch.Tensor, max_step_mm: float,
              carry: dict | None = None):
    """Check :func:`displacement_scan`'s inputs and allocate its outputs:
    ``(args, out, final)``, ``args`` the C entry's arguments but the stream
    (``chip_smoke.py`` times other versions of the entry on them)."""
    dev = _cuda_device(world, "displacement_scan")
    if world.ndim != 3 or world.shape[2] != 3:
        raise ValueError(f"displacement_scan: world must be (B, N, 3), got "
                         f"{tuple(world.shape)}")
    b, n = world.shape[:2]
    f32 = torch.float32
    _check(world, "displacement_scan: world", f32, (b, n, 3), dev)
    _check(seen, "displacement_scan: seen", torch.bool, (b, n), dev)
    schema = dict(last=(f32, (n, 3)), last_ok=(torch.bool, (n,)),
                  first=(f32, (n, 3)), first_ok=(torch.bool, (n,)),
                  cum=(f32, (n,)))
    if carry is not None:
        for key, (dt, shape) in schema.items():
            _check(carry[key], f"displacement_scan: carry[{key!r}]", dt, shape,
                   dev)
    out = (torch.empty((b, n, 3), dtype=f32, device=dev),
           torch.empty((b, n), dtype=f32, device=dev),
           torch.empty((b, n), dtype=torch.bool, device=dev),
           torch.empty((b, n), dtype=f32, device=dev),
           torch.empty((b, n, 3), dtype=f32, device=dev),
           torch.empty((b, n), dtype=f32, device=dev))
    final = {key: torch.empty(shape, dtype=dt, device=dev)
             for key, (dt, shape) in schema.items()}
    cin = ([None] * 5 if carry is None
           else [carry[key].data_ptr() for key in schema])
    args = (world.data_ptr(), seen.data_ptr(), b, n, float(max_step_mm), *cin,
            *(t.data_ptr() for t in out),
            *(t.data_ptr() for t in final.values()))
    return args, out, final


def displacement_scan(world: torch.Tensor, seen: torch.Tensor,
                      max_step_mm: float, carry: dict | None = None):
    """One launch of the displacement scan over ``world (B, N, 3)`` float32
    and ``seen (B, N)`` bool. Returns ``(step, step_norm, step_valid,
    cum_path, from_first, from_first_norm)`` and the final carry (the
    ``initial_carry`` schema); ``carry=None`` starts from the fresh state."""
    global scan_launches
    args, out, final = scan_args(world, seen, max_step_mm, carry)
    lib = build.library()
    with torch.cuda.device(world.device):   # build.py: launches go to it
        err = lib.vbs_displacement_scan(
            *args, torch.cuda.current_stream(world.device).cuda_stream)
    build.check(err, "displacement_scan kernel launch")
    scan_launches += 1
    return out, final


def assoc_args(ref, det, gate_px: float,
               carry_xy: torch.Tensor | None = None):
    """Check :func:`associate_sequential`'s inputs and allocate its outputs:
    ``(args, out, last)``, ``args`` the C entry's arguments but the stream."""
    dev = _cuda_device(ref.xy, "associate_sequential")
    n = ref.xy.shape[0]
    if det.valid.ndim != 2:
        raise ValueError(f"associate_sequential: detections need one leading "
                         f"frame axis, got valid {tuple(det.valid.shape)}")
    b, k = det.valid.shape
    if not 1 <= n <= MAX_SLOTS or not 1 <= k <= MAX_DETECTIONS:
        raise ValueError(f"associate_sequential: the kernel takes 1..{MAX_SLOTS}"
                         f" slots and 1..{MAX_DETECTIONS} detections a frame, "
                         f"got {n} and {k}")
    f32 = torch.float32
    _check(ref.xy, "associate_sequential: ref.xy", f32, (n, 2), dev)
    _check(ref.valid, "associate_sequential: ref.valid", torch.bool, (n,), dev)
    _check(det.xy, "associate_sequential: det.xy", f32, (b, k, 2), dev)
    _check(det.axes, "associate_sequential: det.axes", f32, (b, k, 2), dev)
    _check(det.angle, "associate_sequential: det.angle", f32, (b, k), dev)
    _check(det.valid, "associate_sequential: det.valid", torch.bool, (b, k),
           dev)
    if carry_xy is not None:
        _check(carry_xy, "associate_sequential: carry_xy", f32, (n, 2), dev)
    out = (torch.empty((b, n, 2), dtype=f32, device=dev),
           torch.empty((b, n, 2), dtype=f32, device=dev),
           torch.empty((b, n), dtype=f32, device=dev),
           torch.empty((b, n), dtype=torch.bool, device=dev))
    last = torch.empty((n, 2), dtype=f32, device=dev)
    args = (ref.xy.data_ptr(), ref.valid.data_ptr(), det.xy.data_ptr(),
            det.axes.data_ptr(), det.angle.data_ptr(), det.valid.data_ptr(),
            None if carry_xy is None else carry_xy.data_ptr(), b, n, k,
            float(gate_px), *(t.data_ptr() for t in out), last.data_ptr())
    return args, out, last


def associate_sequential(ref, det, gate_px: float,
                         carry_xy: torch.Tensor | None = None):
    """One launch of the sequential association over ``det``'s frames
    (``xy``/``axes`` ``(B, K, 2)``, ``angle`` ``(B, K)`` float32, ``valid``
    ``(B, K)`` bool) against ``ref`` (``xy (N, 2)``, ``valid (N,)``).
    Returns ``(xy, axes, angle, valid)`` per frame and slot, and the final
    last-seen positions ``(N, 2)``; ``carry_xy=None`` starts from
    ``ref.xy``. N <= MAX_SLOTS and 1 <= K <= MAX_DETECTIONS."""
    global assoc_launches
    args, out, last = assoc_args(ref, det, gate_px, carry_xy)
    lib = build.library()
    with torch.cuda.device(ref.xy.device):   # build.py: launches go to it
        err = lib.vbs_associate_sequential(
            *args, torch.cuda.current_stream(ref.xy.device).cuda_stream)
    build.check(err, "associate_sequential kernel launch")
    assoc_launches += 1
    return out, last
