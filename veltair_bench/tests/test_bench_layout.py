"""The benchmark is driven by its data files: every cell, configuration,
traffic mix and per-layer metric is found by name, and BENCHMARK.json
keeps to the contract's shapes."""
from __future__ import annotations

import json
import re

import pytest

from veltair_bench import cells, references

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["veltair_bench"]
    assert BENCH["command"][1].startswith("veltair_bench/")
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = cells.load(cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for t in c.config["tenants"]:
        ref = references.load(t["reference"])
        assert ref.layout(t["config"]) and ref.port_fields(t["config"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(cells.reader(metric))


def test_names_units_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        # every cell it lists reports the metric it moves
        for w in m.get("workloads", CELLS):
            assert m["moves"] in {x["name"] for x in cells.load(w).end_to_end}


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        doc = json.loads((cells.ROOT / c["file"]).read_text())
        # every key changed from the source: cuts of scale, and the
        # program's own departures, which the file keeps apart
        keys = {k for t in doc["tenants"]
                for k in list(t["reduced"]) + list(t["departures"])}
        flat = {k.split(".")[-1] for k in c["reduced"]}
        assert keys == flat
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert doc["engine"]["deployment"]


def test_every_config_keeps_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
