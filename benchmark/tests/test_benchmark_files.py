"""Every file ``BENCHMARK.json`` names loads by its name, and the file
keeps the contract's shape."""

import json
import os
import re

import pytest

from benchmark import harness, traffic
from conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_load(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and 1 <= len(cfg["source"]) <= 200
    data = harness.load_json(ROOT, cfg["file"])
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    for key in ("lattice", "diel_type", "n", "nev", "iterate", "refine",
                "guarantees", "block_width"):
        assert key in data


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cells_load_with_their_metrics(name, traced):
    c = harness.cell(name, traced)
    assert c.chips == 1 and c.limits["omega_gap"] > 0
    traffic.plan(c.mix, c.config, 7)
    names = {m["name"] for m in c.metrics}
    if traced:
        assert names, "every cell reports a per-layer metric"
    else:
        assert "setup_s" in names and len(names) >= 2
    for m in c.metrics:
        assert callable(harness.reader(m["name"]).read)


def test_metric_entries_keep_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_workloads_name_their_files():
    seen = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(harness.HERE, "limits",
                                           f"{w['name']}.json"))
        traffic.load(w["traffic"])
    # the driver's whole check at the full 24 cells fits its budget
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
