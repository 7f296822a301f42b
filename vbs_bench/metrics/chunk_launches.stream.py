"""Device activities (kernels, copies, fills) a chunk launched inside the
program's ``vbs.pipeline.chunk`` span (``StreamingPipeline.process``),
counted on the device: a CUDA graph's kernels count one each, so the
host's launch calls, which a graph makes fewer, are not what it reads."""
from vbs_bench import program_spans


def read(ctx):
    n = program_spans.launches(ctx.trace, "vbs.pipeline.chunk")
    t = ctx.traffic
    return n / (ctx.units * (t["frames"] // t["chunk"])) if n else None
