"""The port's wavefront engine (models/whitted_wavefront.py) against the
JAX package's and against the port's sweep.

Against JAX's wavefront: the scenes and configs of tests/test_wavefront.py
(mount, mixed and sphere_plane under the default, reference_exact,
physical refraction and the soft-shadow grid), at atol 5e-4, the JAX
test's own tolerance (f32 reassociation only). Against the port's sweep on
one drawn sample plan: every distribution flag on the branch-2 tree and on
the reflective-only and refractive-only trees (branch 1, where a node's
path is its parent's), at 5e-4, which shows that the queue reads its draws
by (pixel, path) as the sweep does. Capacity overflow drops the children
JAX's queue drops. ``engine="megakernel"`` on a scene over the kernel's
envelope renders through the wavefront. A round reads nothing on the host.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.models import scenes as jscenes
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import samples, scenes
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import whitted as pw
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_megakernel as mk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_wavefront as wf,
)
from test_whitted_vs_oracle import sphere_plane_scene
from torch_parity import (  # one_torch_thread: an autouse fixture
    jax_render_image,
    jax_scene_to_port,
    mixed_scene,
    one_torch_thread,
)

CPU = torch.device("cpu")
RES = 16
ATOL = 5e-4   # tests/test_wavefront.py:39

SCENES = {
    "mount": lambda: jscenes.mount_scene(res=RES),
    "mixed": lambda: mixed_scene(rt.SceneDef(), res=RES),
    "sphere_plane": lambda: sphere_plane_scene(res=RES),
}
CONFIGS = {
    "default": {},
    "reference_exact": {"fresnel_mode": "reference_exact"},
    "physical": {"refraction_mode": "physical"},
    "soft_shadow_grid": {"soft_shadow": True},
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_wavefront_matches_jax_wavefront(name, config):
    jscene = rt.build_scene(SCENES[name]())
    kw = CONFIGS[config]
    want = jax_render_image(jscene, rt.RenderConfig(engine="wavefront", **kw))
    got = pt.render_image(jax_scene_to_port(jscene),
                          pt.RenderConfig(engine="wavefront", **kw))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _tree_scene(tree, res=12):
    """mixed_scene with both children (branch 2), or with the transmission
    (reflective-only) or the specular weights (refractive-only) zeroed:
    branch 1."""
    sd = mixed_scene(pt.SceneDef(), res=res)
    sd.camera["aperture_ratio"] = 2.0
    for m in sd.materials:
        if tree == "reflective":
            m[9] = 0.0
        elif tree == "refractive":
            m[7] = 0.0
    scene = pt.build_scene(sd, device=CPU)
    assert (scene.has_reflective, scene.has_transmissive) == {
        "both": (True, True), "reflective": (True, False),
        "refractive": (False, True)}[tree]
    return scene


FLAGS = {
    "aa_dof_motion": dict(anti_aliasing=True, spp=2, depth_of_field=True,
                          motion_blur=True),
    "soft_shadow": dict(anti_aliasing=True, spp=2, soft_shadow=True),
    "fuzzy": dict(fuzzy_reflection=True, roughness=0.6),
    "sky": dict(use_skybox=True, wavefront_defer_sky=True),
    "all": dict(anti_aliasing=True, spp=2, depth_of_field=True,
                motion_blur=True, soft_shadow=True, fuzzy_reflection=True,
                use_skybox=True),
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("tree", ["both", "reflective", "refractive"])
def test_wavefront_matches_sweep_on_one_plan(tree, flags):
    scene = _tree_scene(tree)
    scene = dataclasses.replace(
        scene, skybox=torch.from_numpy(scenes.synthetic_skybox(16, seed=4)),
        has_skybox=True)
    cfg = pt.RenderConfig(max_depth=4, **FLAGS[flags])
    layout = samples.scene_layout(scene, cfg)
    if flags in ("soft_shadow", "all") or (flags == "fuzzy"
                                           and tree != "refractive"):
        assert layout.n_rows > 0
    px, py = pw.pixel_grid(12, 12, CPU)
    draws = samples.draw_plan(torch.Generator().manual_seed(3), layout, cfg,
                              px.shape[0])
    want = pw.render_tile(scene, px, py, cfg, draws=draws)
    got = pw.render_tile(scene, px, py,
                         dataclasses.replace(cfg, engine="wavefront"),
                         draws=draws)
    assert float(want.std()) > 0.01
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("tree", ["both", "reflective", "refractive"])
def test_node_values_read_the_sweeps_slots(tree):
    """A queue entry's draw, read by (pixel, path), is the sweep's slot
    ray·W + path of the same level, for every row of every level of a
    layout with jittered soft shadows (two lights) and fuzzy reflection."""
    has_refl, has_refr = {"both": (True, True), "reflective": (True, False),
                          "refractive": (False, True)}[tree]
    cfg = pt.RenderConfig(max_depth=4, anti_aliasing=True, spp=2,
                          soft_shadow=True, fuzzy_reflection=True)
    layout = samples.stream_layout(has_refl, has_refr, 2, cfg)
    R = 7
    rows = torch.rand((layout.n_rows, R), generator=torch.Generator(
        ).manual_seed(0))
    for lvl in range(layout.shape.n_levels):
        W = layout.shape.branch ** lvl
        pix, path = torch.meshgrid(torch.arange(R), torch.arange(W),
                                   indexing="ij")
        pix, path = pix.reshape(-1), path.reshape(-1)
        perm = torch.randperm(pix.shape[0],
                              generator=torch.Generator().manual_seed(lvl))
        sweep = samples.NodeDraws(layout, lvl, rows)
        queue = samples.NodeDraws(layout, lvl, rows, pix[perm], path[perm])
        for off in range(layout.node_rows[lvl]):
            assert torch.equal(queue.values(off),
                               sweep.values(off)[perm]), (lvl, off)
        if layout.has_fuzzy(lvl):
            assert torch.equal(queue.sphere(), sweep.sphere()[perm])


def test_wavefront_capacity_overflow_drops_gracefully():
    """A tiny queue (capacity 0.05) drops children beyond it: the image
    stays finite, close to the full render (tests/test_wavefront.py:95-104),
    unchanged where the primary ray spawns nothing, and equal to JAX's, so
    the queue keeps and drops the same children in the same order."""
    jscene = rt.build_scene(mixed_scene(rt.SceneDef(), res=RES))
    scene = jax_scene_to_port(jscene)
    full = pt.render_image(scene, pt.RenderConfig(engine="wavefront"))
    tiny = pt.render_image(scene, pt.RenderConfig(engine="wavefront",
                                                  wavefront_capacity=0.05))
    assert bool(torch.isfinite(tiny).all())
    assert float((tiny - full).abs().mean()) < 0.1
    assert float((tiny - full).abs().max()) > 0.01  # children were dropped
    primary = (pt.render_image(scene, pt.RenderConfig(max_depth=1))
               == full).all(dim=-1)
    assert int(primary.sum()) > RES
    assert torch.equal(tiny[primary], full[primary])
    want = jax_render_image(jscene, rt.RenderConfig(
        engine="wavefront", wavefront_capacity=0.05))
    np.testing.assert_allclose(tiny.numpy(), want, atol=ATOL)


def test_megakernel_engine_degrades_on_a_field():
    """A 258-sphere field (over the kernel's 256) and mount_low at depth 9
    (over its 8) render through the wavefront on engine="megakernel", the
    choice made from the scene and the config alone."""
    field = pt.build_scene(scenes.sphere_field_scene(n_side=16, res=8),
                           device=CPU)
    cfg = pt.RenderConfig(engine="megakernel")
    assert field.n_objects > mk.MAX_PRIMS and not mk.supports(field, cfg)
    assert pw.engine_of(field, cfg) == "wavefront"
    img = pt.render_image(field, cfg)
    assert torch.equal(img, pt.render_image(
        field, pt.RenderConfig(engine="wavefront")))
    np.testing.assert_allclose(img.numpy(), pt.render_image(
        field, pt.RenderConfig()).numpy(), atol=ATOL)
    mount = pt.build_scene(scenes.mount_scene(res=6), device=CPU)
    deep = pt.RenderConfig(engine="megakernel", max_depth=mk.MAX_DEPTH + 1)
    assert pw.engine_of(mount, deep) == "wavefront"
    assert pw.engine_of(mount, cfg) == "megakernel"
    assert torch.equal(pt.render_image(mount, deep), pt.render_image(
        mount, dataclasses.replace(deep, engine="wavefront")))


class _HostReads(TorchDispatchMode):
    """Records the ops that read a tensor's value on the host or size a
    result by its data."""

    READS = ("_local_scalar_dense", "nonzero", "item", "masked_select",
             "unique")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(r in name for r in self.READS) or (
                "index" in name and any(
                    isinstance(a, torch.Tensor) and a.dtype == torch.bool
                    for a in torch.utils._pytree.tree_leaves(args))):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_a_round_reads_nothing_on_the_host():
    """The queue's live count stays a device tensor: on mount_low (brute
    force, sync-free) a depth-4 frame through the wavefront makes no host
    read and sizes nothing by the data, and adds its rounds after the
    first to the queue's counter; the module reads no scalar."""
    source = inspect.getsource(wf)
    for call in (".item(", ".tolist(", "nonzero", ".cpu(", "int(n_"):
        assert call not in source, call
    scene = pt.build_scene(scenes.mount_scene(res=8), device=CPU)
    px, py = pw.pixel_grid(8, 8, CPU)
    rays = pt.models.whitted.subpixel_rays(
        scene, px, py, pt.RenderConfig(), samples.Draws(None, None, None,
                                                        None, None))
    counter = wf.live_counter(CPU)
    before = counter.clone()
    with _HostReads() as mode:
        out = wf.trace_rays_wavefront(scene, rays, pt.RenderConfig())
    live = counter - before
    assert mode.seen == []
    assert int(live[0]) == 0 and not live[4:].any()
    assert 0 < int(live[1]) <= 64
    np.testing.assert_allclose(out.clamp(0, 1).numpy(), pw.trace_rays(
        scene, rays, pt.RenderConfig()).clamp(0, 1).numpy(), atol=ATOL)


def test_wavefront_on_a_grid_scene_walks_and_traces_perray():
    """On a grid scene the wavefront's queries take the walk, and under
    accel_impl="perray" the grid DDA with the dead suffix of the queue."""
    sd = mixed_scene(pt.SceneDef(), res=10)
    grid = pt.build_scene(sd, device=CPU, accel=C.ACCEL_GRID)
    want = pt.render_image(grid, pt.RenderConfig())
    for impl in ("auto", "perray"):
        got = pt.render_image(grid, pt.RenderConfig(engine="wavefront",
                                                    accel_impl=impl))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_cli_names_the_engine_that_ran(tmp_path, capsys):
    """--engine megakernel on the CLI's 258-object field runs (and says it
    runs) the wavefront; --capacity sets its queue."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import cli

    out = str(tmp_path / "f.png")
    assert cli.main(["render", "--builtin", "spheres", "--engine",
                     "megakernel", "--capacity", "0.5", "--res", "6",
                     "--device", "cpu", "-o", out]) == 0
    text = capsys.readouterr().out
    assert "engine wavefront (engine megakernel asked for" in text
    assert "capacity 0.5" in text
