"""Small runs of the harness on the CPU for the tests: the cell's program
and reference at a few pixels, the chip's look skipped (``--device cpu``)."""
from __future__ import annotations

import json
import subprocess
import sys

from portbench.harness import ROOT

# a few pixels and steps a cell, so a run takes seconds on the CPU
SMALL_ORBIT = {"config": {"scene_args": {"size": 2, "res": 16}},
               "traffic": {"trace_frames": 3, "warmup_s": 0.0}}
SMALL = {
    "spd_balls_bvh.orbit": SMALL_ORBIT,
    "spd_balls_brute.orbit": SMALL_ORBIT,
    "mount_lights.fit": {"config": {"scene_args": {"res": 16}},
                         "traffic": {"job_steps": 5, "trace_steps": 2}},
}


def run(cell: str, *extra, seed: int = 2147483651, seconds: float = 0.5,
        trace: int = 0, timeout: float = 240.0, chips: int = 0):
    """(exit code, the last stdout line as JSON or None, stderr) of a
    small CPU run of ``cell``, with ``chips`` ranks where given."""
    small = dict(SMALL[cell], **({"chips": chips} if chips else {}))
    argv = [sys.executable, "-m", "portbench.run", "--workload", cell,
            "--seed", str(seed), "--seconds", str(seconds), "--trace",
            str(trace), "--device", "cpu", "--override",
            json.dumps(small), *extra]
    p = subprocess.run(argv, cwd=str(ROOT), capture_output=True, text=True,
                       timeout=timeout)
    lines = p.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr


def calibrate(cell: str, seeds, control: bool = False,
              seconds: float = 0.3):
    argv = [sys.executable, "-m", "portbench.run", "--workload", cell,
            "--seed", "0", "--seconds", str(seconds), "--device", "cpu",
            "--override", json.dumps(SMALL[cell]),
            "--calibrate", ",".join(map(str, seeds))]
    if control:
        argv.append("--control")
    p = subprocess.run(argv, cwd=str(ROOT), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(x) for x in p.stdout.strip().splitlines()]
