"""Sorted sparse-to-dense expansion (K8).

Port of ``benchmarks/scatter_onehot_kernel.py:expand_sorted`` as the
hand-written CUDA kernel ``csrc/expand_sorted.cu``: the scatter of every
JPEG transport (``ops/jpeg.py``). The plain version is
``ops/expand.py:expand_sorted_reference``. Dispatch: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from vision_basedsensor_tpu_torch.ops.cuda import build
from vision_basedsensor_tpu_torch.ops.expand import expand_sorted_reference

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
launches = 0


def _check_stream(p: torch.Tensor, v: torch.Tensor, dev: torch.device,
                  what: str) -> None:
    if p.device != dev or v.device != dev:
        raise ValueError(f"expand_sorted: {what} must lie on {dev}, got "
                         f"{p.device} and {v.device}")
    if (p.dtype != torch.int32 or v.dtype != torch.int16 or p.ndim != 1
            or tuple(v.shape) != tuple(p.shape) or not p.is_contiguous()
            or not v.is_contiguous()):
        raise ValueError(f"expand_sorted: {what} must be contiguous 1-D int32 "
                         f"positions and int16 values of one length, got "
                         f"{p.dtype} {tuple(p.shape)} and {v.dtype} "
                         f"{tuple(v.shape)}")
    if p.numel() >= 2 ** 31:
        raise ValueError(f"expand_sorted: {what} has {p.numel()} entries, "
                         f"beyond the int32 index space")


def expand_sorted(pos: torch.Tensor, val: torch.Tensor, total: int,
                  spill_pos: torch.Tensor | None = None,
                  spill_val: torch.Tensor | None = None) -> torch.Tensor:
    """Dense ``(total,)`` int16 from the sorted stream ``pos``/``val`` plus
    the optional sorted ``spill_pos``/``spill_val`` stream; entries outside
    ``[0, total)`` drop (contract: ``expand_sorted_reference``)."""
    global launches
    if pos.device.type == "cpu":
        return expand_sorted_reference(pos, val, total, spill_pos, spill_val)
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"expand_sorted: unsupported device {dev}")
    if (spill_pos is None) != (spill_val is None):
        raise ValueError("expand_sorted: spill_pos and spill_val go together")
    if not 0 <= total < 2 ** 31:
        raise ValueError(f"expand_sorted: total {total} outside [0, 2^31)")
    _check_stream(pos, val, dev, "pos/val")
    n, m = pos.numel(), 0
    sp = sv = None
    if spill_pos is not None:
        _check_stream(spill_pos, spill_val, dev, "spill_pos/spill_val")
        m = spill_pos.numel()
        sp, sv = spill_pos.data_ptr(), spill_val.data_ptr()
    out = torch.empty(total, dtype=torch.int16, device=dev)
    if total == 0:
        return out
    if out.data_ptr() % 16:   # the kernel's 16-byte stores
        raise ValueError("expand_sorted: output not 16-byte aligned")
    lib = build.library()
    with torch.cuda.device(dev):   # build.py: launches go to it
        err = lib.vbs_expand_sorted(
            pos.data_ptr(), val.data_ptr(), n, sp, sv, m, out.data_ptr(),
            total, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "expand_sorted kernel launch")
    launches += 1
    return out
