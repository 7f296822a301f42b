"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m vbs_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: build or load the port's kernels (in the checkout's ``build/``),
make the cell's inputs on the card from the seed, warm up the cell's own
shapes, then measure for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or trace the traffic file's ``trace_units`` units under
the profiler (``--trace 1``: its per-layer metrics), check what the timed
path produced against the plain reference, and print one JSON line. Set-up
is timed from this module's first line to the first timed operation; the
seconds that building or loading the kernels took within it (the compile
of a checkout's first run) are given apart, as ``build_s``.
Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2; with JAX or the JAX package loaded, with 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             program=None, traffic_overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of ``workload`` on ``device``; returns the result object.
    ``program`` replaces the port (the control, the tests' faults)."""
    import torch

    from vbs_bench import check, manifest
    from vbs_bench.loads import load
    from vbs_bench.program import Program
    from vbs_bench.trace import Spans, Trace, export_events, instrument

    t_start = time.perf_counter() if t_start is None else t_start
    m = manifest.load()
    cell = manifest.cell(m, workload)
    conf = manifest.config(m, cell)
    traffic = {**manifest.traffic(cell), **(traffic_overrides or {})}
    program = program or Program(device)
    t_build = time.perf_counter()
    program.build(ingest=traffic["kind"] == "replay")
    build_s = time.perf_counter() - t_build
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    built = time.perf_counter() - t_start
    drv = load(traffic["kind"])(program, conf, traffic, seed, device)
    print(f"set-up: imports, context and kernels {built!r} s (of which "
          f"building or loading the kernels {build_s!r} s), " + ", ".join(
              f"{k} {v!r} s" for k, v in drv.phases.items()),
          file=sys.stderr)
    try:
        setup_s = time.perf_counter() - t_start
        e2e, tr, spans = {}, None, Spans()
        if not trace:
            e2e = drv.window(seconds)
        else:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            rf = torch.profiler.record_function
            with instrument(program.layer_targets(), spans, rf):
                with torch.profiler.profile(activities=acts) as prof:
                    with rf("vbs.window"):
                        drv.run(traffic["trace_units"])
                        if cuda:
                            torch.cuda.synchronize(device)
            tr = Trace(export_events(prof))
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        attempted = drv.attempted
        drv.release()
        if cuda:
            torch.cuda.empty_cache()
        numbers = drv.check()
        correct, table = check.verdict(numbers, traffic["limits"])
        correct = correct and attempted > 0

        metrics = {}
        if not trace:
            for e in manifest.e2e_of(m, workload):
                value = setup_s if e["name"] == "setup_s" else e2e[e["name"]]
                metrics[e["name"]] = {"value": value, "unit": e["unit"]}
        else:
            ctx = SimpleNamespace(trace=tr, spans=spans, units=attempted,
                                  conf=conf, traffic=traffic, stats=drv.stats)
            for e in manifest.per_layer_of(m, workload):
                value = manifest.reader(e["name"])(ctx)
                if value is not None:
                    metrics[e["name"]] = {"value": value, "unit": e["unit"]}
        dev = {"platform": "gpu" if cuda else device.type,
               "kind": torch.cuda.get_device_name(device) if cuda
               else device.type,
               "count": 1, "memory_peak_bytes": peak}
        # A unit that raises ends the run without a result, so none failed.
        # ``build_s``: the part of ``setup_s`` that built or loaded the
        # kernels (a checkout's first run compiles them), recorded apart.
        result = {"correct": correct, "attempted": attempted, "failed": 0,
                  "metrics": metrics, "device": dev, "build_s": build_s}
        if trace:
            dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
            result["breakdown"] = tr.breakdown()
        result["checks"] = table
        return result
    finally:
        close = getattr(drv, "close", None)
        if close:
            close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m vbs_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from vbs_bench import check, guard, manifest
    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vbs_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t_start=T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"vbs_bench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    check.print_table(result["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
