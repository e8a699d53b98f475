"""The program's own spans and counters, read in windows of their own: what
the per-layer metrics ``launch_ms.*``, ``graph_host_ms.*``,
``launch_idle_ms.*``, ``captures.*`` and ``queue_fill.frame`` read.

The first of these metrics' readers called in a traced run (``measured``:
once a run, the result kept on the outcome) starts a process of its own,

    python3 -m portbench.spans --cell JSON --device cuda|cpu

which runs the cell's program on the same card and prints one JSON object.
A process of its own, because the traced run's profiler leaves the CUDA
profiling interface attached to its process, and every later launch there
pays for it (on an H100, 0.41 ms of host time in a frame's entry call
before a profile, 1.19 ms after it). That process builds the scene, and
for a fit the step, and warms up as the cell's set-up does
(``portbench/drivers``), then runs

  * a window of ``SPANS_X`` times the traffic's traced units, spans off,
    timed on the host's clock alone: what the spans cost when on;
  * the spans window: as many units, the program's span recorder on
    (``utils/profiling.record_spans``) and no profiler. The graph cache's
    captures and the wavefront queue's counter
    (``models/whitted_wavefront.live_counter``) are read before it and
    after it, one sync each. Each entry call is timed on the host's clock
    too, and each unit's ``rt.call`` spans must lie inside it;
  * in a frame cell, one eye's queue counts from a replay and from an eager
    ``render_tile``, which must agree;
  * on a card, last, the profiler's window: the traffic's traced units
    under ``torch.profiler``, spans on, so that the program's ranges sit on
    the device trace's clock: the device's idle time inside the
    ``rt.launch`` ranges, and the idle gaps by the innermost program span
    covering the middle of each.

What is not a metric (the checks, the idle gaps by span, the frame time
with spans on and off) is printed on standard error. A program without the
span recorder gives nothing: the readers return None and nothing runs. A
``--trace 0`` run reads no per-layer metric, so none of this runs there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from . import trace
from .harness import ROOT, sync

SPANS_X = 10                           # spans-window units per traced unit
CHILD_TIMEOUT_S = 600.0                # the spans window's process at most
WINDOW = "portbench.spans_window"      # the profiler window's own range
OUTSIDE = "outside the program"        # an idle gap no program span covers


def measured(out) -> dict:
    """The program's spans and counters for outcome ``out`` (module doc),
    measured at the first call: {} where the program has no span recorder
    or the measurement failed (printed)."""
    got = getattr(out, "_program_spans", None)
    if got is None:
        got = {}
        if _profiling() is not None:
            got = _child(out)
        out._program_spans = got
    return got


def _child(out) -> dict:
    cell = json.dumps({"config": out.config, "traffic": out.traffic,
                       "unit": out.window.unit,
                       "unit_s": out.window.wall_s / max(out.window.count,
                                                         1)})
    device = "cuda" if out.device.get("platform") == "gpu" else "cpu"
    try:
        p = subprocess.run([sys.executable, "-m", "portbench.spans", "--cell",
                            cell, "--device", device], cwd=str(ROOT),
                           stdout=subprocess.PIPE, stderr=sys.stderr,
                           text=True, timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print("portbench: the spans window timed out", file=sys.stderr)
        return {}
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        print(f"portbench: the spans window exited {p.returncode}",
              file=sys.stderr)
        return {}
    return json.loads(lines[-1])


def _profiling():
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "take_spans") else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.spans")
    p.add_argument("--cell", required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    spec = json.loads(args.cell)
    profiling = _profiling()
    if profiling is None:
        return 2
    torch.set_num_threads(4)
    device = (torch.device("cuda", 0) if args.device == "cuda"
              else torch.device("cpu"))
    cell = SimpleNamespace(config=spec["config"], traffic=spec["traffic"])
    kind = cell.traffic.get("kind")
    if kind == "orbit":
        got = _orbit(cell, device, profiling)
    elif kind == "fit":
        got = _fit(cell, device, profiling)
    else:
        return 2
    unit = spec["unit"]
    print(f"portbench: spans window: {got['units']} {unit}s, "
          f"{1e3 * got['unit_s']:.4f} ms a {unit} with spans on, "
          f"{1e3 * got['off_unit_s']:.4f} ms with them off just before; the "
          f"measured window {1e3 * spec['unit_s']:.4f} ms (spans off)",
          file=sys.stderr)
    print(json.dumps(got), flush=True)
    return 0


def _orbit(cell, device, profiling) -> dict:
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import whitted
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_wavefront as wf,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.samples import (
        subpixels,
    )

    from .drivers import orbit

    v = orbit.Viewer(cell, device)
    n_eyes = v.eyes.shape[0]

    def scene_at(k):
        return dataclasses.replace(v.scene, camera=v.p.with_eye(
            v.scene.camera, v.eyes[k % n_eyes]))

    def frame(k):
        s = scene_at(k)
        t0 = time.perf_counter_ns()
        img = v.p.render_image(s, v.cfg)
        t1 = time.perf_counter_ns()
        orbit._u8_host(img)
        return t0, t1

    # set-up as the orbit's: the capture, then frames for warmup_s
    k = -1
    w0 = time.perf_counter()
    for _ in range(int(cell.traffic["warmup_frames"])):
        frame(k)
        k -= 1
    while time.perf_counter() - w0 < float(cell.traffic["warmup_s"]):
        frame(k)
        k -= 1
    counter = wf.live_counter(device)
    units = SPANS_X * int(cell.traffic["trace_frames"])
    got, live = _spans_window(profiling, v.p.graphs.CACHE, counter, device,
                              units, frame)
    depth = min(v.cfg.max_depth, wf.LEVELS)
    cam = v.scene.camera
    if whitted.engine_of(v.scene, v.cfg) == "wavefront" and depth > 1 and (
            v.scene.has_reflective or v.scene.has_transmissive):
        cap = math.ceil(cam.res_x * cam.res_y * v.cfg.wavefront_capacity)
        offered = units * len(subpixels(v.cfg)) * cap * (depth - 1)
        got["queue_fill"] = 100.0 * sum(live[1:depth]) / offered
        # one eye: a replay's counts and an eager frame's
        s = scene_at(units)
        before = counter.clone()
        v.p.render_image(s, v.cfg)
        mid = counter.clone()
        px, py = whitted.pixel_grid(cam.res_x, cam.res_y, device)
        whitted.render_tile(s, px, py, v.cfg)
        replay = (mid - before)[1:depth].tolist()
        eager = (counter - mid)[1:depth].tolist()
        print(f"portbench: one eye's queue entries a round after the "
              f"first: replay {replay}, eager render_tile {eager}: "
              f"{'equal' if replay == eager else 'DIFFERENT'}",
              file=sys.stderr)
    if device.type == "cuda":
        n = int(cell.traffic["trace_frames"])
        got.update(_profiled(profiling, device, n,
                             lambda: [frame(units + 1 + i) for i in range(n)]))
    v.release()
    return got


def _fit(cell, device, profiling) -> dict:
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_wavefront as wf,
    )

    from .drivers import fit

    f = fit.Fitter(cell, device)
    state = [f.start(fit.job_offset(f.desc, cell.traffic, 0, 1))]

    def step(_):
        t0 = time.perf_counter_ns()
        s, loss = f.step_fn(state[0], f.target, None)
        t1 = time.perf_counter_ns()
        state[0] = s
        float(loss)
        return t0, t1

    for i in range(int(cell.traffic["check_steps"])):
        step(i)
    units = SPANS_X * int(cell.traffic["trace_steps"])
    got, _ = _spans_window(profiling, f.p.graphs.CACHE,
                           wf.live_counter(device), device, units, step)
    if device.type == "cuda":
        n = int(cell.traffic["trace_steps"])
        got.update(_profiled(profiling, device, n,
                             lambda: [step(i) for i in range(n)]))
    f.release()
    return got


def _spans_window(profiling, cache, counter, device, units, run_unit):
    """({units, unit_s, off_unit_s, launch_ms, graph_host_ms, captures},
    the queue counter's gain a round) over ``units`` calls of
    ``run_unit(i)``, which returns the host clock's (start, end) ns of its
    entry call; before them as many calls with the spans off."""
    sync(device)
    w0 = time.perf_counter()
    for i in range(units):
        run_unit(i)
    off = (time.perf_counter() - w0) / units
    captures0, live0 = cache.captures, counter.clone()
    sync(device)
    profiling.take_spans()
    outer = []
    was = profiling.record_spans(True)
    try:
        w0 = time.perf_counter()
        for i in range(units):
            outer.append(run_unit(i))
        wall = time.perf_counter() - w0
    finally:
        profiling.record_spans(was)
    spans = profiling.take_spans()
    live = (counter - live0).tolist()   # one sync
    got = dict(units=units, unit_s=wall / units, off_unit_s=off,
               captures=cache.captures - captures0)
    got.update(_span_sums(spans, outer))
    return got, live


def _span_sums(spans, outer) -> dict:
    """Mean ms a unit inside the ``rt.launch`` spans, and of the ``rt.call``
    spans less their launches; each unit's calls held to its entry call's
    clock (printed)."""
    dur = [s.end_ns - s.start_ns for s in spans]
    units = sorted({s.unit for s in spans if s.unit >= 0})
    calls = [i for i, s in enumerate(spans)
             if s.name == "rt.call" and s.unit >= 0]
    launch = sum(dur[i] for i, s in enumerate(spans)
                 if s.name == "rt.launch" and s.unit >= 0)
    call_ids = set(calls)
    in_calls = sum(dur[i] for i, s in enumerate(spans)
                   if s.name == "rt.launch" and s.parent in call_ids)
    call = sum(dur[i] for i in calls)
    n = len(outer)
    clock = dict(zip(units, outer))
    inside = len(units) == n and all(
        clock[spans[i].unit][0] <= spans[i].start_ns
        and spans[i].end_ns <= clock[spans[i].unit][1] for i in calls)
    host = sum(t1 - t0 for t0, t1 in outer)
    print(f"portbench: spans window: {len(units)} units of {n}; every "
          f"rt.call inside its entry call: {inside}; launch + the rest of "
          f"the call {(launch + call - in_calls) / 1e6:.3f} ms against "
          f"{host / 1e6:.3f} ms inside the entry calls", file=sys.stderr)
    by_name = {}
    for s, d in zip(spans, dur):
        by_name[s.name] = by_name.get(s.name, 0) + d
    print("portbench: spans window: ms a unit by span: " + json.dumps(
        {k: round(v / 1e6 / n, 4) for k, v in by_name.items()}),
        file=sys.stderr)
    return dict(launch_ms=launch / 1e6 / n,
                graph_host_ms=(call - in_calls) / 1e6 / n)


def _profiled(profiling, device, units, run_units) -> dict:
    """{launch_idle_ms}: ``run_units()`` (``units`` units) under the
    profiler with the spans on: device-idle ms a unit inside the
    ``rt.launch`` ranges; the idle gaps by program span printed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prefix = profiling.PREFIX
    run_units()   # the profiler's own start-up is not in the window
    sync(device)
    profiling.take_spans()
    was = profiling.record_spans(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                run_units()
                sync(device)
    finally:
        profiling.record_spans(was)
        profiling.take_spans()
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [e.time_range for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith((prefix, trace.SPAN))]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e.time_range for e in cpu if e.name == WINDOW]
    mine = [e for e in cpu if e.name.startswith(prefix)]
    if not win or not dev:
        return {}
    lo, hi = win[0].start, win[0].end
    merged = trace._merged((r.start, r.end) for r in dev)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(max(a, lo), min(b, hi)) for a, b in zip(edges[0::2], edges[1::2])
            if min(b, hi) > max(a, lo)]
    launches = [e.time_range for e in mine if e.name == "rt.launch"]
    idle_in_launch = sum(max(0, min(b, r.end) - max(a, r.start))
                         for a, b in gaps for r in launches)
    by_span = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = [e for e in mine
                 if e.time_range.start <= mid <= e.time_range.end]
        name = (min(cover, key=lambda e: e.time_range.elapsed_us()).name
                if cover else OUTSIDE)
        by_span[name] = by_span.get(name, 0.0) + (b - a) / 1e6
    print("portbench: device idle by program span, s over "
          f"{units} units: " + json.dumps(dict(sorted(
              by_span.items(), key=lambda kv: -kv[1]))), file=sys.stderr)
    return dict(launch_idle_ms=idle_in_launch / 1e3 / units)


if __name__ == "__main__":
    sys.exit(main())
