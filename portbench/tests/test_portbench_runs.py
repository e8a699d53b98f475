"""Whole runs of the harness on the CPU at a few pixels: a sound run is
correct and reports its cell's metrics; each fault the cell can have,
planted underneath the timed path, makes ``correct`` false; a run that
ends with JAX loaded prints no result."""
from __future__ import annotations

import json

import pytest

from portbench.harness import ROOT
from portbench.tests import runs

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
FAULTS = {
    "orbit": ("frame_stale", "frame_half", "frame_altered"),
    "fit": ("step_unchanged", "step_half", "step_altered"),
}


def _kind(cell):
    traffic = {w["name"]: w["traffic"] for w in BENCH["workloads"]}[cell]
    return json.loads((ROOT / "portbench" / "traffic"
                       / f"{traffic}.json").read_text())


def _e2e(cell):
    return {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rc, line, err = runs.run(cell)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == _e2e(cell)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(x.startswith("check ") for x in last)


@pytest.mark.parametrize("cell", ["spd_balls_bvh.orbit",
                                  "mount_lights.fit"])
def test_traced_run_reports_per_layer(cell):
    rc, line, err = runs.run(cell, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["metrics"], "no per-layer metric read"
    assert not set(line["metrics"]) & _e2e(cell)


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS[_kind(c)["kind"]]])
def test_planted_fault_is_not_correct(cell, fault):
    rc, line, err = runs.run(cell, "--fault", fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, (fault, line["checks"])


@pytest.mark.parametrize("fault", ["", "step_no_exchange"])
def test_fit_on_two_ranks_needs_the_exchange(fault):
    """A fit cell of two chips runs a rank a process (gloo on the CPU): it
    is correct, and not with the exchange between ranks left out."""
    rc, line, err = runs.run("mount_lights.fit", "--fault", fault, chips=2,
                             timeout=400.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is (not fault), line["checks"]
    assert line["device"]["count"] == 2


def test_jax_loaded_at_the_end_prints_no_result():
    rc, line, err = runs.run("mount_lights.fit", "--fault", "load_jax")
    assert rc == 3 and line is None
    assert "jax" in err


def test_no_card_exits_without_a_result():
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "spd_balls_bvh.orbit", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=str(ROOT), capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_exits_without_a_result(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "mount_lights.fit", "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--device", "cpu"], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
