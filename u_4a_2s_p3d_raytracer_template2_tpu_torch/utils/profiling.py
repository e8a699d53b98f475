"""Phase timers, ray accounting and profiler traces: the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/utils/profiling.py``.

``PhaseTiming``, ``RenderStats`` and ``ray_count`` are JAX's. ``trace``
records a ``torch.profiler`` trace of the CPU and, where there is a card,
CUDA activity, and writes it as a Chrome trace (``trace.json`` in its
directory, for chrome://tracing or Perfetto), in place of JAX's
``xla_trace``. JAX's ``enable_compilation_cache`` has no counterpart: it
kept XLA's compiled programs across processes, and the port compiles no
programs at run time except its CUDA kernels, which ``kernels/build.py``
keeps in ``build/kernels/`` by the hash of their sources.

A host clock around device work measures the enqueue unless the work ends
in ``torch.cuda.synchronize()``; a phase that times CUDA work must end in
one (``utils/timing.py`` times frames with CUDA events).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional


@dataclasses.dataclass
class PhaseTiming:
    name: str
    seconds: float
    rays: int = 0

    @property
    def mrays_per_s(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds > 0 else 0.0


class RenderStats:
    """Per-phase host timings and the structured metrics lines."""

    def __init__(self):
        self.phases: list[PhaseTiming] = []

    @contextlib.contextmanager
    def phase(self, name: str, rays: int = 0):
        t0 = time.perf_counter()
        yield
        self.phases.append(PhaseTiming(name, time.perf_counter() - t0, rays))

    def report(self) -> str:
        lines = []
        for p in self.phases:
            extra = f" — {p.mrays_per_s:.2f} Mrays/s" if p.rays else ""
            lines.append(f"{p.name}: {p.seconds:.3f}s{extra}")
        return "\n".join(lines)

    def json(self) -> str:
        return json.dumps([dataclasses.asdict(p) for p in self.phases])


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write ``<log_dir>/trace.json`` as a Chrome trace;
    yields the profiler, or None and records nothing without a
    ``log_dir``."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def ray_count(res_x: int, res_y: int, n_lights: int, spp: int = 0,
              max_depth: int = 4) -> dict:
    """Ray accounting of the Whitted pipeline: the primary rays, primary
    plus top-level shadow rays (the convention of the Mrays/s lines), and
    the whole tree's upper bound (every slot of every level active)."""
    samples = max(spp, 1) ** 2 if spp > 0 else 1
    base = res_x * res_y * samples
    primary_shadow = base * (1 + n_lights)
    slots = (2 ** max_depth) - 1
    upper = base * slots * (1 + n_lights)
    return dict(primary=base, primary_shadow=primary_shadow,
                tree_upper_bound=upper)
