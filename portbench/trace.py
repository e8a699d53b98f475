"""The traced window: ``torch.profiler``'s CPU and CUDA events over a fixed
number of frames or steps, reduced to what the per-layer metrics read.

The reduction is ``chip_smoke.profile_frames``' (copied): device busy time
is the union of the device's kernel and copy intervals, the host's launch
calls are its CPU events named ``*LaunchKernel*`` and ``*GraphLaunch*``,
and kernel time is summed by name. Beside it, the idle gaps: the stretches
of the window in which the device ran nothing, each named by the innermost
host event that covered its middle (what the host was doing then).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

WINDOW = "portbench.window"   # the record_function around the traced loop
SPAN = "portbench."           # the prefix of the benchmark's own ranges
TOP = 10                      # entries of each breakdown list
NAME_CHARS = 160              # a breakdown name's length at most


@dataclasses.dataclass
class Trace:
    units: int            # frames or steps traced
    window_s: float       # the traced window's host wall time
    busy_s: float         # union of the device's intervals in it
    device_ops: int       # device events (kernels, copies, sets)
    launch_calls: int     # host launch calls (kernels and graphs)
    kernel_us: dict       # device time by event name, us
    breakdown: dict       # device_ops, idle_gaps: [[name, seconds], ...]

    def kernels_ms(self, parts) -> float:
        """Device ms a unit in the events whose names hold one of
        ``parts``."""
        us = sum(v for k, v in self.kernel_us.items()
                 if any(p in k for p in parts))
        return us / 1e3 / self.units


def _merged(intervals):
    out = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


def _label(cpu, lo: float, hi: float) -> str:
    """The innermost host event covering the middle of [lo, hi]."""
    mid = 0.5 * (lo + hi)
    best = None
    for e in cpu:
        r = e.time_range
        if r.start <= mid <= r.end and e.name != WINDOW and (
                best is None or r.elapsed_us() < best.time_range.elapsed_us()):
            best = e
    return "host idle" if best is None else best.name


def summarize(prof, units: int, window_s: float) -> Trace:
    from torch.autograd import DeviceType

    events = prof.events()
    # the benchmark's ranges show on the device's timeline too, as
    # annotations that span their work: they are not device operations
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(SPAN)]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in cpu if e.name == WINDOW]
    kernel_us = {}
    for e in dev:
        kernel_us[e.name] = kernel_us.get(e.name, 0.0) + e.time_range.elapsed_us()
    merged = _merged((e.time_range.start, e.time_range.end) for e in dev)
    busy_us = sum(b - a for a, b in merged)
    gaps = {}
    if win:
        lo, hi = win[0].time_range.start, win[0].time_range.end
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b > a:
                name = _label(cpu, a, b)
                gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    launch_calls = sum(("LaunchKernel" in e.name) or ("GraphLaunch" in e.name)
                       for e in cpu)

    def top(d, scale):
        return [[k[:NAME_CHARS], v * scale] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Trace(units=units, window_s=window_s, busy_s=busy_us / 1e6,
                 device_ops=len(dev), launch_calls=launch_calls,
                 kernel_us=kernel_us,
                 breakdown={"device_ops": top(kernel_us, 1e-6),
                            "idle_gaps": top(gaps, 1.0)})


def span(name: str, on: bool):
    """A profiler range named ``portbench.<name>`` where ``on`` (the traced
    window), so an idle gap is named by the step the host was in; else
    nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(SPAN + name)


def traced(run_units, units: int, device) -> Trace:
    """Run ``run_units()`` (which runs ``units`` frames or steps) under the
    profiler, inside the window's range, and summarise it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            run_units()
            if on_card:
                torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return summarize(prof, units, window_s)
