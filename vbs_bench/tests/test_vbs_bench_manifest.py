"""BENCHMARK.json against the manifest's format, and every name in it found
as a file."""
import copy
import inspect
import json

import pytest

from vbs_bench import loads, manifest

M = manifest.load()


def test_benchmark_json_has_no_problems():
    assert manifest.problems(M) == []


def test_command_and_paths():
    assert M["command"][:3] == ["python3", "-m", "vbs_bench.run"]
    assert M["paths"] == ["vbs_bench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("entry", M["end_to_end"] + M["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_names_and_units_use_the_allowed_characters(entry):
    assert manifest.NAME.fullmatch(entry["name"])
    assert manifest.UNIT.fullmatch(entry["unit"])
    assert entry["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {e["name"] for e in manifest.e2e_of(M, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = manifest.per_layer_of(M, cell["name"])
    assert layers
    assert all(e["moves"] in e2e for e in layers)
    traffic = manifest.traffic(cell)
    assert (manifest.HERE / "loads" / f"{traffic['kind']}.py").is_file()
    assert inspect.isclass(loads.load(traffic["kind"]))
    assert traffic["limits"]
    conf = manifest.config(M, cell)
    assert conf["name"] == cell["config"]


@pytest.mark.parametrize("entry", M["per_layer"], ids=lambda e: e["name"])
def test_each_per_layer_metric_has_a_reader(entry):
    assert callable(manifest.reader(entry["name"]))


@pytest.mark.parametrize("edit, expect", [
    (lambda m: m["workloads"][0].update(name="bad name"), "bad name"),
    (lambda m: m["end_to_end"][0].update(unit="frames per s"), "bad unit"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves nothing"),
    (lambda m: m["workloads"][0].update(traffic="absent"), "no traffic"),
    (lambda m: m["end_to_end"][0].update(bound=0.5), "bound"),
    (lambda m: m["per_layer"][0].update(why="a key too many"), "keys"),
    (lambda m: m["configs"][0].update(why="two\nlines"), "bad why"),
])
def test_problems_are_found(edit, expect):
    m = copy.deepcopy(M)
    edit(m)
    assert any(expect in p for p in manifest.problems(m))
