"""The program's spans window (``portbench/spans.py``) in whole small runs
on the CPU: a traced run reads the spans metrics, and against a program
without the span recorder their readers read nothing."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from portbench.harness import ROOT
from portbench.tests import runs

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPANS_METRICS = ("launch_ms", "graph_host_ms", "launch_idle_ms", "captures",
                 "queue_fill")


def _unit(cell):
    traffic = {w["name"]: w["traffic"] for w in BENCH["workloads"]}[cell]
    kind = json.loads((ROOT / "portbench" / "traffic"
                       / f"{traffic}.json").read_text())["kind"]
    return "frame" if kind == "orbit" else "step"


@pytest.mark.parametrize("cell", ["spd_balls_bvh.orbit",
                                  "mount_lights.fit"])
def test_traced_run_reads_the_spans_window(cell):
    """The spans window's metrics read numbers (``launch_idle_ms`` needs a
    card's profile), no frame or step captured a graph, and every
    ``rt.call`` lies inside its entry call."""
    rc, line, err = runs.run(cell, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    unit = _unit(cell)
    spans = {f"{m}.{unit}" for m in ("launch_ms", "graph_host_ms",
                                     "captures")}
    if unit == "frame":
        spans.add("queue_fill.frame")
    assert spans <= set(line["metrics"]), err[-3000:]
    assert line["metrics"][f"captures.{unit}"]["value"] == 0
    if unit == "frame":
        assert 0 < line["metrics"]["queue_fill.frame"]["value"] <= 100
    assert "every rt.call inside its entry call: True" in err


def test_untraced_run_reads_no_spans_metric():
    rc, line, err = runs.run("spd_balls_bvh.orbit")
    assert rc == 0, err[-3000:]
    assert not {m.split(".")[0] for m in line["metrics"]} & set(
        SPANS_METRICS)
    assert "spans window" not in err


def test_spans_readers_read_nothing_without_the_recorder(monkeypatch):
    """Against a program without the span recorder (the parent of the
    spans window's metrics), their readers return None and run nothing."""
    from portbench import harness, spans

    monkeypatch.setattr(spans, "_profiling", lambda: None)
    names = [m["name"] for m in BENCH["per_layer"]
             if m["name"].split(".")[0] in SPANS_METRICS]
    assert len(names) == 9
    for unit in ("frame", "step"):
        out = SimpleNamespace(window=SimpleNamespace(unit=unit))
        assert [harness.reader(n)(out) for n in names] == [None] * 9
