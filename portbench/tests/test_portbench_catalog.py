"""Every cell, configuration, traffic mix and metric of ``BENCHMARK.json``
loads by its name from its own file, and the harness refuses a name it
has no file for."""

import json
import pathlib
import re
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import catalog  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_match_the_benchmark(w):
    cell = catalog.cell(w["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == w[key], key
    config = catalog.config(cell["config"])
    mix = catalog.traffic(cell["traffic"])
    assert catalog.driver(mix["kind"]).run
    assert catalog.family(config["family"]).layout
    assert set(cell["limits"]) == {"loss", "grad", "change"}
    assert config["name"] in {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    config = catalog.config(c["name"])
    assert ROOT / c["file"] == catalog.HERE / "configs" / f"{c['name']}.json"
    assert config["reduced"] == c["reduced"]
    assert config["source"] == c["source"]
    for key in c["reduced"]:
        assert key in config and key in config["published"]
    assert sum(w["config"] == c["name"] for w in BENCH["workloads"]) >= 1


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(catalog.reader(m["name"]))
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    for w in m.get("workloads", []):
        assert w in {x["name"] for x in BENCH["workloads"]}


def test_benchmark_shape():
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics_of_a_cell():
    bench = {
        "end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["y"]}],
        "per_layer": [{"name": "c", "workloads": ["x"]}, {"name": "d"}],
    }
    assert [m["name"] for m in catalog.metrics_of(bench, "x", traced=True)] == ["c", "d"]
    assert [m["name"] for m in catalog.metrics_of(bench, "y", traced=True)] == ["d"]
    assert [m["name"] for m in catalog.metrics_of(bench, "x", traced=False)] == ["a"]
    for w in BENCH["workloads"]:
        untraced = {m["name"] for m in catalog.metrics_of(BENCH, w["name"], traced=False)}
        assert "setup_s" in untraced and len(untraced) >= 2
        assert catalog.metrics_of(BENCH, w["name"], traced=True)


@pytest.mark.parametrize(
    "load", [catalog.cell, catalog.config, catalog.traffic, catalog.reader, catalog.driver, catalog.family]
)
@pytest.mark.parametrize("name", ["no-such-name", "../BENCHMARK", "a b"])
def test_unknown_names_are_refused(load, name):
    with pytest.raises(catalog.Unknown):
        load(name)
