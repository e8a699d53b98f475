"""The port's multi-process entry points on the CPU: ``entry.entry`` and
``entry.dryrun_multichip`` (the counterpart of __graft_entry__.py) on two
gloo ranks, and ``cli fit`` under torchrun with two processes, its steps
sharded over the group and its lines printed by rank 0 alone. Every spawn
and subprocess has a timeout that fails the test."""
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch import entry

from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_entry_forward():
    fn, args = entry.entry("cpu")
    out = fn(*args)
    assert out.shape == (64 * 64, 3) and bool(torch.isfinite(out).all())


def test_dryrun_multichip_two_ranks():
    got = entry.dryrun_multichip(2, device="cpu")
    assert got["image"].shape == (entry.RES, entry.RES, 3)
    assert got["loss"] > 0.0 and got["frame"].shape == (entry.RES,
                                                        entry.RES, 3)


def test_cli_fit_under_torchrun():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "u_4a_2s_p3d_raytracer_template2_tpu_torch.cli", "fit",
         "--builtin", "mount", "--res", "8", "--steps", "4", "--lr", "2",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120, check=True).stdout
    assert out.count("fit materials: 8x8") == 1, out
    assert "2 rank(s)" in out
    losses = [float(x) for x in re.findall(r"step \d+: loss ([\d.]+)", out)]
    assert len(losses) == 4, out
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
