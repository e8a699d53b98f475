"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file that serves it."""
from __future__ import annotations

import json
import re

import pytest

from portbench.harness import PKG, ROOT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    for entry in BENCH["configs"] + BENCH["workloads"] + METRICS:
        assert NAME.match(entry["name"]), entry["name"]
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if m in BENCH["end_to_end"] else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys, m["name"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_its_reader(metric):
    assert (PKG / "metrics" / f"{metric}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_and_reports_enough(cell):
    c = load_cell(cell)
    assert (PKG / "drivers" / f"{c.traffic['kind']}.py").is_file()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            moves = {x["name"] for x in load_cell(w).end_to_end}
            assert m["moves"] in moves, (m["name"], w)


def test_configs_and_pairs():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
