"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the file its ``configs`` entry names, its traffic
mix ``traffic/<traffic>.json``, each of its per-layer metrics
``metrics/<name>.py``. Adding a configuration, a mix or a metric is adding
files and entries: nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def load(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def problems(m: dict) -> list[str]:
    """Every way ``m`` departs from the manifest's format: keys, names,
    units, lines and cross references."""
    out = []
    if set(m) != KEYS["top"]:
        out.append(f"top-level keys {sorted(m)}")
    names = []
    for kind, section in (("config", "configs"), ("workload", "workloads"),
                          ("end_to_end", "end_to_end"),
                          ("per_layer", "per_layer")):
        for e in m.get(section, []):
            extra = set(e) - KEYS[kind] - ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set())
            if extra or KEYS[kind] - set(e):
                out.append(f"{section} {e.get('name')}: keys {sorted(e)}")
            names.append((section, e.get("name")))
            for key in ("name", "config", "traffic", "moves"):
                if key in e and not NAME.fullmatch(str(e[key])):
                    out.append(f"{section} {e.get('name')}: bad {key}")
            for key in ("why", "layer", "source"):
                if key in e and not _line(e[key]):
                    out.append(f"{section} {e.get('name')}: bad {key}")
            if "unit" in e and not UNIT.fullmatch(e["unit"]):
                out.append(f"{section} {e['name']}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"{section} {e['name']}: better {e['better']!r}")
    for section in ("configs", "workloads"):
        seen = [n for s, n in names if s == section]
        if len(seen) != len(set(seen)):
            out.append(f"{section}: duplicate names")
    metrics = [n for s, n in names if s in ("end_to_end", "per_layer")]
    if len(metrics) != len(set(metrics)):
        out.append("metrics: duplicate names")
    configs = {c["name"]: c for c in m.get("configs", [])}
    cells = {w["name"] for w in m.get("workloads", [])}
    e2e = {e["name"]: e for e in m.get("end_to_end", [])}
    for c in configs.values():
        if not PATH.fullmatch(c["file"]) or not (ROOT / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        for key in c["reduced"]:
            if not NAME.fullmatch(key):
                out.append(f"config {c['name']}: bad reduced key {key}")
    for w in m.get("workloads", []):
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: no config {w['config']}")
        if not (HERE / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"workload {w['name']}: no traffic {w['traffic']}")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips {w['chips']}")
    for e in m.get("end_to_end", []):
        if not 0.0 < e["bound"] <= 0.25:
            out.append(f"{e['name']}: bound {e['bound']}")
        if e["source"] not in ("host_clock", "device_trace"):
            out.append(f"{e['name']}: source {e['source']}")
    for e in m.get("per_layer", []):
        if e["moves"] not in e2e:
            out.append(f"{e['name']}: moves {e['moves']}, no such metric")
        if not (HERE / "metrics" / f"{e['name']}.py").is_file():
            out.append(f"{e['name']}: no reader metrics/{e['name']}.py")
        for cell in e.get("workloads", []):
            if cell not in cells:
                out.append(f"{e['name']}: no cell {cell}")
            elif e["moves"] not in {x["name"] for x in e2e_of(m, cell)}:
                out.append(f"{e['name']}: {cell} does not report "
                           f"{e['moves']}")
    for e in m.get("end_to_end", []):
        for cell in e.get("workloads", []):
            if cell not in cells:
                out.append(f"{e['name']}: no cell {cell}")
    return out


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(m: dict, w: dict) -> dict:
    entry = next(c for c in m["configs"] if c["name"] == w["config"])
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def traffic(w: dict) -> dict:
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        return json.load(f)


def e2e_of(m: dict, name: str) -> list[dict]:
    """The end-to-end metrics that cell ``name`` reports."""
    return [e for e in m["end_to_end"]
            if name in e.get("workloads", [name])]


def per_layer_of(m: dict, name: str) -> list[dict]:
    """The per-layer metrics that cell ``name`` reports in a traced run."""
    moved = {e["name"] for e in e2e_of(m, name)}
    return [e for e in m["per_layer"]
            if name in e.get("workloads", [name] if e["moves"] in moved
                             else [])]


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"vbs_bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
