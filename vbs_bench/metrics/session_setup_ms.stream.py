"""Host milliseconds a session inside the program's
``vbs.undistort.prepare`` span (``pipeline.py:prepare_undistortion``: the
rectified pinhole, whose border is undistorted on the device and read back,
and the rectify map) and its ``vbs.pipeline.initialize`` span (frame 0
rectified, detected and given its identities), both on the session's first
chunk."""
from vbs_bench import program_spans


def read(ctx):
    prepare = program_spans.host_s(ctx.trace, "vbs.undistort.prepare")
    init = program_spans.host_s(ctx.trace, "vbs.pipeline.initialize")
    if prepare is None or init is None:
        return None
    return 1e3 * (prepare + init) / ctx.units
