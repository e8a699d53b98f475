"""The port's compiled programs (utils/graphs.py) on the CPU: the graph
cache's key and its bound, the static-input copy and the output clones,
the launch counts, ``loop_ms``'s slope, and every compiled callable against
its eager function.

A CUDA graph cannot be captured here, so the mechanics run through a
stand-in (``FakeGraphs``): its "capture" runs the program once and keeps
its outputs as the static ones, its "replay" runs the program again on the
static inputs and writes the results into those outputs, as a replay
writes into the graph's buffers. The compiled callables themselves run
their eager functions on CPU tensors. Imports no JAX; one process, a few
seconds:

    python -m pytest -n 0 --durations=5 tests/test_torch_graphs.py
"""
import dataclasses

import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import build_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import RenderConfig
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import pathtracer as pt
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    pt_megakernel as ptk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import whitted
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_megakernel as mk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
    glsl_camera,
    glsl_world,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    mount_distribution_scene,
    mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
    orbit_eye,
    with_eye,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs, timing

RES = 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch on one thread, as tests/torch_parity.one_torch_thread (which
    imports JAX): the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeGraphs:
    """A stand-in for ``graphs.CudaGraphs`` on the CPU (module doc)."""

    def warm_up(self, device, run):
        run()

    def capture(self, device, run, generator):
        out = run()
        return (run, out), out

    def replay(self, graph):
        run, out = graph
        counters = [f for f in vars(kernels).values()
                    if callable(f) and hasattr(f, "launches")]
        before = [k.launches for k in counters]
        new = run()  # a replay launches nothing from Python
        for k, n in zip(counters, before):
            k.launches = n
        for s, x in zip(graphs.flatten(out)[0], graphs.flatten(new)[0]):
            s.copy_(x)

    def reserved_mib(self, device):
        return 0.0


@pytest.fixture
def fake(monkeypatch):
    """The compiled callables on CPU tensors through FakeGraphs: a fresh
    graph cache, and the CPU treated as the card."""
    cache = graphs.GraphCache(FakeGraphs())
    monkeypatch.setattr(graphs, "CACHE", cache)
    monkeypatch.setattr(graphs, "on_card", lambda device: True)
    return cache


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


def _mount(res=RES):
    return build_scene(mount_scene(res=res), device=CPU)


def _orbit(scene, alpha):
    cam = scene.camera
    r = float(torch.linalg.vector_norm(cam.eye))
    return dataclasses.replace(
        scene, camera=with_eye(cam, orbit_eye(cam, alpha, 10.0, r)))


def test_graph_cache_key(fake):
    """One structure replays one graph; a scene with a new camera from
    dataclasses.replace replays it too; a new config or R captures."""
    scene = _mount()
    cfg = RenderConfig(max_depth=2)
    px, py = whitted.pixel_grid(RES, RES, CPU)
    whitted.render_tile_compiled(scene, px, py, cfg)
    whitted.render_tile_compiled(scene, px + 0.37, py, cfg)
    whitted.render_image(_orbit(scene, 30.0), cfg)  # the same program
    assert fake.captures == 1
    lit = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, color=scene.lights.color * 0.5))
    whitted.render_image(lit, cfg)
    assert fake.captures == 1
    whitted.render_image(scene, dataclasses.replace(cfg, max_depth=3))
    assert fake.captures == 2
    whitted.render_tile_compiled(scene, px[:32], py[:32], cfg)
    assert fake.captures == 3
    whitted.render_image(scene, cfg, tile_rows=2)  # other tiles
    assert fake.captures == 4
    [g] = [g for k, g in fake.graphs.items() if k[1] == (cfg, RES * RES)]
    assert g.replays == 4


def test_static_inputs_are_copied_and_outputs_cloned():
    cache = graphs.GraphCache(FakeGraphs())
    a, b = torch.arange(4.0), torch.arange(4.0) + 10

    def twice(x, generator):
        return (x * 2, {"not": "a tensor"}["not"])

    out_a, tag = cache.call("twice", twice, (a,))
    out_b, _ = cache.call("twice", twice, (b,))
    assert tag == "a tensor" and cache.captures == 1
    [g] = cache.graphs.values()
    assert g.inputs[0] is not b and torch.equal(g.inputs[0], b)
    assert torch.equal(out_a, a * 2) and torch.equal(out_b, b * 2)
    assert out_a.data_ptr() != g.outputs[0].data_ptr()  # a clone
    a += 1  # the caller's tensor is not the graph's
    assert torch.equal(g.inputs[0], b)


def test_wrappers_count_only_the_launches_they_make():
    """A wrapper counts the warm-up's launches and the one a capture
    records; the replays run the graph without it and add nothing (the
    card counts them: utils/profiling.device_launches)."""
    cache = graphs.GraphCache(FakeGraphs())
    k = kernels.whitted_megakernel

    def launch(x, generator):
        k.launches += 1
        return x + 1

    n0 = k.launches
    for i in range(3):
        cache.call("launch", launch, (torch.zeros(2) + i,))
    assert k.launches - n0 == graphs.WARMUP + 1
    [g] = cache.graphs.values()
    assert g.replays == 3


def test_graph_cache_keeps_the_programs_called_last(monkeypatch):
    """Each program keeps its PER_PROGRAM graphs called last: a new
    signature past them drops the least recently called one, which
    captures again when it comes back; other programs keep theirs."""
    monkeypatch.setattr(graphs, "PER_PROGRAM", 2)
    cache = graphs.GraphCache(FakeGraphs())

    def call(name, n):
        return cache.call(name, lambda x, g: x + 1, (torch.zeros(n),))

    call("other", 1)
    for n in (1, 2, 1, 3):  # 2 is the least recently called when 3 comes
        call("frame", n)
    assert cache.captures == 4
    assert sorted(k[2][2][0][1] for k in cache.graphs
                  if k[0] == "frame") == [(1,), (3,)]
    assert torch.equal(call("frame", 2), torch.ones(2))
    assert cache.captures == 5
    call("other", 1)
    assert cache.captures == 5 and len(cache.graphs) == 3


def test_each_wrapper_names_a_device_kernel_of_its_source():
    """device_launches counts a wrapper's runs by ``.device_kernel``: a
    ``__global__`` function of csrc/, matched as a whole word of the
    profiler's demangled names."""
    import pathlib
    import re

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.profiling import (
        launched,
    )

    csrc = pathlib.Path(kernels.__file__).parent.parent / "csrc"
    src = "".join(p.read_text() for p in csrc.glob("*.cu"))
    defined = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", src))
    wrappers = [f for f in vars(kernels).values()
                if callable(f) and hasattr(f, "launches")]
    assert len(wrappers) == 14
    assert {w.device_kernel for w in wrappers} <= defined
    assert len({w.device_kernel for w in wrappers}) == 13  # any, multi: one
    names = ["void closest_kernel<true>(float const*, float const*, int)",
             "brute_closest_sweep(float const*, int)",
             "void at::native::vectorized_elementwise_kernel<4>(int)",
             "void any_kernel<false>(float const*)",
             "void whitted_kernel<4>(Params)", "pt_kernel(Params)",
             "void median_bvh_closest_kernel<false>(float const*, Bvh)",
             "void grid_any_kernel<false>(float const*, Grid)"]
    assert [launched(names, k) for k in (
        "closest_kernel", "brute_closest_sweep", "any_kernel",
        "whitted_kernel", "pt_kernel", "elementwise",
        "median_bvh_closest_kernel", "grid_any_kernel")] == [
            1, 1, 1, 1, 1, 0, 1, 1]


def test_capture_failure_names_the_program():
    class Refuses(FakeGraphs):
        def capture(self, device, run, generator):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    cache = graphs.GraphCache(Refuses())
    with pytest.raises(RuntimeError, match="capturing host_sync") as e:
        cache.call("host_sync", lambda x, g: x, (torch.zeros(1),))
    assert "not permitted" in str(e.value.__cause__)
    assert not cache.graphs and cache.captures == 0


class _Clock:
    def __init__(self):
        self.now, self.fresh, self.calls = 0.0, False, []


def test_loop_ms_slope_with_a_fake_event_clock(monkeypatch):
    """T(n) = 7 + 1.5·n ms (a fixed cost on the first call after an event),
    so the slope reads 1.5 whatever the fixed cost; every call gets an
    index of its own."""
    clock = _Clock()

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = clock.now
            clock.fresh = True

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.t - self.t

    def step(i):
        clock.calls.append(i)
        clock.now += 1.5 + (7.0 if clock.fresh else 0.0)
        clock.fresh = False

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    assert timing.loop_ms(step, n_lo=2, n_hi=12, reps=3) == pytest.approx(1.5)
    assert clock.calls == list(range(1 + 3 * 14))


def _dist_scene():
    scene = build_scene(mount_distribution_scene(res=RES), device=CPU)
    cfg = RenderConfig(max_depth=2, soft_shadow=True, fuzzy_reflection=True,
                       motion_blur=True).with_scene_flags(scene)
    return scene, dataclasses.replace(cfg, spp=2)


@pytest.mark.parametrize("engine", ["sweep", "wavefront", "megakernel"])
def test_compiled_frames_replay_the_eager_draws(fake, engine):
    """Through the stand-in graph: a distribution frame on two seeds and on
    a generator already advanced by one frame equals the eager frame bit
    for bit, and leaves the generator where the eager frame leaves it; the
    scene's lights are graph inputs, not constants."""
    scene, cfg = _dist_scene()
    cfg = dataclasses.replace(cfg, engine=engine)
    moved = dataclasses.replace(_orbit(scene, 20.0), lights=dataclasses.replace(
        scene.lights, color=scene.lights.color * 0.7))
    advanced = _gen(2)
    whitted.render_image(scene, cfg, advanced)
    runs = [(scene, _gen(1)), (moved, _gen(5)), (scene, advanced)]
    eager_gens = [(s, _gen(0)) for s, _ in runs]
    for (_, g), (_, e) in zip(runs, eager_gens):
        e.set_state(g.get_state())
    got = [whitted.render_image(s, cfg, g) for s, g in runs]
    px, py = whitted.pixel_grid(RES, RES, CPU)
    want = [whitted.render_tile(s, px, py, cfg, e).reshape(RES, RES, 3)
            for s, e in eager_gens]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (_, g), (_, e) in zip(runs, eager_gens):
        assert torch.equal(g.get_state(), e.get_state())
    assert not torch.equal(got[0], got[1])
    assert fake.captures == 1


def test_megakernel_tile_compiles_every_subpixel(fake):
    scene, cfg = _dist_scene()
    tile = mk.make_render_tile(scene, cfg)
    px, py = whitted.pixel_grid(RES, RES, CPU)
    g, e = _gen(3), _gen(3)
    got = tile(px, py, g)
    want = mk.render_tile(scene, px, py, cfg, e)
    assert torch.equal(got, want) and torch.equal(g.get_state(),
                                                  e.get_state())


def test_compiled_path_tracer_frames_progress(fake):
    """Four progressive compiled frames equal four eager ones bit for bit:
    the generator advances frame to frame."""
    scene = glsl_world(device=CPU)
    cam = glsl_camera(RES, RES, device=CPU)
    cfg = pt.PTConfig(max_bounces=3)
    frame = ptk.make_render_frame(scene, cam, cfg)
    tables = ptk.pt_tables(scene)

    def eager(g):
        return ptk.render_frame_megakernel(tables, cam, cfg, g)

    got = pt.render_progressive(scene, cam, cfg, _gen(7), 4, frame_fn=frame)
    want = pt.render_progressive(scene, cam, cfg, _gen(7), 4, frame_fn=eager)
    assert torch.equal(got.sum_linear, want.sum_linear)
    assert fake.captures == 1


def test_compiled_plain_path_tracer_frames_progress(fake):
    """The plain engine's frame (``make_render_frame(..., "plain")``, JAX's
    jitted ``pathtracer.render_frame``) is compiled too: four progressive
    frames equal four eager ``render_frame`` calls bit for bit, in one
    capture, the generator advanced frame to frame."""
    scene = glsl_world(device=CPU)
    cam = glsl_camera(RES, RES, device=CPU)
    cfg = pt.PTConfig(max_bounces=3)
    frame = ptk.make_render_frame(scene, cam, cfg, "plain")
    got = pt.render_progressive(scene, cam, cfg, _gen(9), 4, frame_fn=frame)
    want = pt.render_progressive(scene, cam, cfg, _gen(9), 4)
    assert torch.equal(got.sum_linear, want.sum_linear)
    assert fake.captures == 1


def _light_fit(engine):
    scene = _mount()
    cfg = RenderConfig(max_depth=2, engine=engine)
    target = whitted.render_image(scene, cfg)
    delta = torch.zeros_like(scene.lights.position)
    delta[0] = torch.tensor([1.0, -0.7, 0.5])
    start = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, position=scene.lights.position + delta))
    return start, target, cfg


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_compiled_train_steps_equal_the_eager_steps(fake, engine):
    """Two compiled steps of every group and one of the materials against
    the eager steps: on the CPU the arithmetic is the same, so bit for
    bit."""
    start, target, cfg = _light_fit(engine)
    sc = dist.lr_scales(materials=0.1, light_pos=2.0, camera=0.5,
                        geometry=0.01)
    step = dist.make_train_step(dist.train_step_full, cfg, 0.5, scales=sc)
    s_got, s_want = start, start
    for i in range(2):
        s_got, l_got = step(s_got, target)
        s_want, l_want = dist.train_step_full(s_want, target, cfg, 0.5,
                                              None, sc)
        assert torch.equal(l_got, l_want)
        for a, b in zip(graphs.flatten(s_got)[0], graphs.flatten(s_want)[0]):
            assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(
        dist.tree_leaves(dist.params_of(s_got)),
        dist.tree_leaves(dist.params_of(start))))
    mats = dist.make_train_step(dist.train_step, cfg, 0.5)
    got, l_got = mats(start, target)
    want, l_want = dist.train_step(start, target, cfg, 0.5)
    assert torch.equal(l_got, l_want)
    for f in dataclasses.fields(want.materials):
        assert torch.equal(getattr(got.materials, f.name),
                           getattr(want.materials, f.name))
    assert fake.captures == 3  # the target's frame and the two steps


def test_compiled_callables_on_cpu_tensors_are_the_eager_functions():
    """Without the stand-in, CPU tensors run the eager functions and
    capture nothing."""
    n0 = graphs.CACHE.captures
    scene = _mount()
    cfg = RenderConfig(max_depth=2, engine="megakernel")
    px, py = whitted.pixel_grid(RES, RES, CPU)
    want = whitted.render_tile(scene, px, py, cfg)
    assert torch.equal(whitted.render_tile_compiled(scene, px, py, cfg), want)
    assert torch.equal(whitted.render_image(scene, cfg).reshape(-1, 3), want)
    assert torch.equal(mk.make_render_tile(scene, cfg)(px, py), want)
    start, target, _ = _light_fit("megakernel")
    got, loss = dist.make_train_step(dist.train_step_full, cfg)(start,
                                                                target)
    want_s, want_l = dist.train_step_full(start, target, cfg)
    assert torch.equal(loss, want_l)
    assert torch.equal(got.lights.position, want_s.lights.position)
    assert graphs.CACHE.captures == n0


def test_perray_frames_are_not_captured(fake):
    """The per-ray traversals read nothing back to the host on the card
    (csrc/perray_traverse.cu), so their frames are compiled like every
    other: render_image and render_tile_compiled capture one program under
    accel_impl="perray", and under reference_grid_shadow_initfail on a
    grid scene, each replay equal to the eager frame."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C

    px, py = whitted.pixel_grid(RES, RES, CPU)
    for accel, cfg in (
            (C.ACCEL_BVH, RenderConfig(max_depth=2, accel_impl="perray")),
            (C.ACCEL_GRID, RenderConfig(max_depth=2,
                                        reference_grid_shadow_initfail=True))):
        scene = build_scene(mount_scene(res=RES, accel=accel), device=CPU)
        n0 = fake.captures
        want = whitted.render_tile(scene, px, py, cfg)
        img = whitted.render_image(scene, cfg)
        assert img.shape == (RES, RES, 3) and fake.captures == n0 + 1
        assert torch.equal(img.reshape(-1, 3), want)
        assert torch.equal(whitted.render_tile_compiled(scene, px, py, cfg),
                           want)
        assert fake.captures == n0 + 1
