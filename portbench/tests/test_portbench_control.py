"""The comparison's control: the plain reference computed in bfloat16, one
precision below the configurations' float32, put in the program's place,
must come out not correct, while the program's own readings stay within
the limits. On the CPU at a few pixels; on the card at the cells' own
size (``-m cuda``, run on the chip)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.harness import ROOT, load_cell
from portbench.tests import runs

SEEDS = (11, 2147483653, 977)
CELLS = ("spd_balls_bvh.orbit", "spd_balls_brute.orbit",
         "mount_lights.fit")


def _fails(line, limits) -> bool:
    return any(line[f"control_{k}"] > lim for k, lim in limits.items())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_cpu(cell):
    limits = load_cell(cell).traffic["limits"]
    for line in runs.calibrate(cell, SEEDS, control=True):
        assert all(line[k] <= lim for k, lim in limits.items()), line
        assert _fails(line, limits), line


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(card, cell):
    limits = load_cell(cell).traffic["limits"]
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "0", "--seconds", "2", "--control", "--calibrate",
         ",".join(map(str, SEEDS))], cwd=str(ROOT), capture_output=True,
        text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    for line in map(json.loads, p.stdout.strip().splitlines()):
        assert all(line[k] <= lim for k, lim in limits.items()), line
        assert _fails(line, limits), line
