"""``BENCHMARK.json`` parses, its names and units keep the contract's
alphabet, and every cell finds its files and metrics by name."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_parses_with_its_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield key, entry


@pytest.mark.parametrize("key,entry", list(_names()), ids=lambda v: v if isinstance(v, str)
                         else v["name"])
def test_names_and_units(key, entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for text in ("why", "layer", "source"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
    if key == "workloads":
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    c = spec.resolve(BENCH, cell)
    assert c.check["kind"] in ("batch", "stream", "pool") and c.check["limits"]
    assert c.traffic["channel"] == "AWGN"
    assert {m["name"] for m in c.end_to_end} >= {"frames_per_s", "setup_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_names_a_layer_and_what_it_moves(metric):
    assert metric["layer"].strip()
    for w in BENCH["workloads"]:
        c = spec.resolve(BENCH, w["name"])
        assert metric["moves"] in {m["name"] for m in c.end_to_end}
        assert metric in c.per_layer


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_is_its_own(cfg):
    assert cfg["file"].startswith("portbench/configs/")
    data = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert data["reduced"] == cfg["reduced"] == []
    assert sum(1 for c in BENCH["configs"] if c["file"] == cfg["file"]) == 1
