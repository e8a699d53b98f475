"""The port's span recorder (utils/profiling.span) and the wavefront
queue's counter (models/whitted_wavefront.live_counter) on the CPU.

Spans off record nothing and open no profiler range; spans on nest, carry
the unit of their entry call, and reach ``profiling.trace``'s Chrome
trace; the compiled call (``utils/graphs.GraphCache.call``, through
tests/test_torch_graphs.py's stand-in graphs) and the two entry calls
(``render_image``, a compiled train step) record their spans. The counter
holds the live slots of the sweep's levels, the wavefront's own live
entries under a queue too small for them, and a replay adds what the eager
frame adds. Imports no JAX; a few seconds:

    python -m pytest -n 0 --durations=5 tests/test_torch_spans.py
"""
import dataclasses
import json

import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import build_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import RenderConfig
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import samples, whitted
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_wavefront as wf,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs, profiling
from test_torch_graphs import FakeGraphs, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RES = 8
CALL = ["rt.call", "rt.signature", "rt.copy_in", "rt.launch", "rt.outputs"]


@pytest.fixture
def fake(monkeypatch):
    """The compiled callables on CPU tensors through FakeGraphs: a fresh
    graph cache, and the CPU treated as the card."""
    cache = graphs.GraphCache(FakeGraphs())
    monkeypatch.setattr(graphs, "CACHE", cache)
    monkeypatch.setattr(graphs, "on_card", lambda device: True)
    return cache


@pytest.fixture
def recorded():
    """The recorder on for the test (nothing recorded before it), and off
    after it."""
    profiling.take_spans()
    with profiling.recording():
        yield
    assert not profiling.record_spans(False)


def _mount(**kw):
    return build_scene(mount_scene(res=RES, **kw), device=CPU)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent]


def test_spans_off_record_nothing_and_open_no_range(fake):
    """Off by default: a compiled frame's spans are one shared no-op
    context, record nothing, and put no range on a profiler's trace."""
    from torch.autograd.profiler import profile

    assert not profiling.record_spans(False)
    assert profiling.span("rt.a") is profiling.span("rt.b", entry=True)
    profiling.take_spans()
    scene, cfg = _mount(), RenderConfig(max_depth=2)
    whitted.render_image(scene, cfg)  # the capture
    with profile(use_kineto=False) as prof:
        whitted.render_image(scene, cfg)
    names = [e.name for e in prof.function_events]
    assert profiling.take_spans() == []
    assert "aten::cat" in names  # the copy-in, seen by the profiler
    assert not [n for n in names if n.startswith(profiling.PREFIX)]


def test_spans_nest_with_parents_and_units(recorded):
    """A span's parent is the span it opened in; an entry span outside any
    unit starts one, and everything inside it (an entry span too) shares
    its id; a span outside every unit has unit -1."""
    span = profiling.span
    with span("rt.a", entry=True):
        with span("rt.b"):
            with span("rt.c", entry=True):
                pass
        with span("rt.d"):
            pass
    with span("rt.e"):
        with span("rt.f"):
            pass
    with span("rt.a", entry=True):
        pass
    got = profiling.take_spans()
    assert [s.name for s in got] == ["rt.a", "rt.b", "rt.c", "rt.d", "rt.e",
                                     "rt.f", "rt.a"]
    assert [s.parent for s in got] == [-1, 0, 1, 0, -1, 4, -1]
    u = got[0].unit
    assert u >= 0
    assert [s.unit for s in got] == [u, u, u, u, -1, -1, u + 1]
    for s in got:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    with span("rt.open"):
        with pytest.raises(RuntimeError, match="open"):
            profiling.take_spans()


def test_trace_holds_the_spans(tmp_path):
    """profiling.trace switches the spans on for its block: its Chrome
    trace holds them as ranges; after it the recorder is off and holds
    nothing."""
    profiling.take_spans()
    with profiling.trace(str(tmp_path)):
        with profiling.span("rt.frame", entry=True):
            with profiling.span("rt.launch"):
                torch.ones(64).cumsum(0)
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"rt.frame", "rt.launch"} <= names
    assert profiling.span("rt.x") is profiling.span("rt.y")
    assert profiling.take_spans() == []


def test_graph_cache_call_records_its_parts(recorded):
    """Every call: rt.call holding rt.signature, rt.copy_in, rt.launch and
    rt.outputs; the first also rt.capture, between the signature and the
    copy."""
    cache = graphs.GraphCache(FakeGraphs())
    for i in range(3):
        cache.call("twice", lambda x, g: x * 2, (torch.zeros(4) + i,))
    got = profiling.take_spans()
    calls = [i for i, s in enumerate(got) if s.name == "rt.call"]
    assert len(calls) == 3 and all(got[i].parent == -1 for i in calls)
    first = CALL[:2] + ["rt.capture"] + CALL[2:]
    assert [_children(got, i) for i in calls] == [first[1:], CALL[1:],
                                                  CALL[1:]]
    assert sum(s.name == "rt.capture" for s in got) == 1
    assert all(s.name.startswith(profiling.PREFIX) for s in got)


def test_entry_calls_are_units(fake, recorded):
    """render_image and a compiled train step are entry spans: each call
    one unit, holding its compiled call and the call's launch."""
    scene, cfg = _mount(), RenderConfig(max_depth=2, engine="megakernel")
    target = whitted.render_image(scene, cfg)
    whitted.render_image(scene, cfg)
    step = dist.make_train_step(dist.train_step_full, cfg, 0.5)
    step(scene, target)
    step(scene, target)
    got = profiling.take_spans()
    tops = [s for s in got if s.parent == -1]
    assert [s.name for s in tops] == ["rt.render_image"] * 2 + [
        "rt.train_step"] * 2
    units = [s.unit for s in tops]
    assert len(set(units)) == 4 and min(units) >= 0
    for u in units[1::2]:  # the replays
        assert [s.name for s in got if s.unit == u] == [
            got[[s.unit for s in got].index(u)].name] + CALL
    assert all(s.unit in units for s in got)


def _level_counts(monkeypatch, run):
    """(counter's rounds after run(), each _level_step's live slots)."""
    seen = []
    step = whitted._level_step

    def counted(scene, rays, active, *args):
        seen.append(int(active.sum()))
        return step(scene, rays, active, *args)

    monkeypatch.setattr(whitted, "_level_step", counted)
    counter = wf.live_counter(CPU)
    before = counter.clone()
    run()
    monkeypatch.setattr(whitted, "_level_step", step)
    return (counter - before).tolist(), seen


@pytest.mark.parametrize("capacity", [1.0, 0.25])
def test_counter_counts_the_live_entries_a_round(monkeypatch, capacity):
    """On mount_low at 8x8, depth 4 (mirror and glass): the counter's
    rounds after the first hold the live entries the wavefront traced, and
    at capacity 1 the sweep's live slots of the same level; under a queue
    of a quarter the count is clamped to it; round 0 and the rounds past
    the depth hold nothing."""
    scene = _mount()
    cfg = RenderConfig(max_depth=4, wavefront_capacity=capacity)
    px, py = whitted.pixel_grid(RES, RES, CPU)
    rays = whitted.subpixel_rays(scene, px, py, cfg, samples.Draws(
        None, None, None, None, None))
    got, wave = _level_counts(monkeypatch, lambda: wf.trace_rays_wavefront(
        scene, rays, cfg))
    assert got[0] == 0 and not any(got[4:]) and len(got) == wf.LEVELS
    assert got[1:4] == wave[1:] and all(got[1:4])
    if capacity == 1.0:
        _, sweep = _level_counts(monkeypatch, lambda: whitted.trace_rays(
            scene, rays, cfg))
        assert got[1:4] == sweep[1:]
    else:
        assert max(got) == RES * RES // 4  # a round the queue clamped


def test_a_replay_adds_what_the_eager_frame_adds(fake):
    """A compiled wavefront frame's replay advances the counter by the
    eager frame's counts of the same eye."""
    scene = _mount()
    cfg = RenderConfig(max_depth=4, engine="wavefront")
    whitted.render_image(scene, cfg)  # the capture
    counter = wf.live_counter(CPU)
    before = counter.clone()
    whitted.render_image(scene, cfg)
    mid = counter.clone()
    px, py = whitted.pixel_grid(RES, RES, CPU)
    whitted.render_tile(scene, px, py, cfg)
    assert fake.captures == 1
    assert (mid - before).tolist() == (counter - mid).tolist()
    assert (mid - before)[1:4].all()
    moved = dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, eye=scene.camera.eye * 1.5))
    before = counter.clone()
    whitted.render_image(moved, cfg)
    assert fake.captures == 1 and (counter - before)[1:4].all()
