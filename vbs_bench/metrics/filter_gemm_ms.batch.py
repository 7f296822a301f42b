"""Device milliseconds a batch of the filter GEMMs: the cuBLAS and CUTLASS
kernels by name (``chip_smoke.py``'s ``GEMM_KERNEL``)."""
import re

GEMM_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass", re.IGNORECASE)


def read(ctx):
    s = ctx.trace.device_s(lambda name: bool(GEMM_KERNEL.search(name)))
    return 1e3 * s / ctx.units if s > 0.0 else None
