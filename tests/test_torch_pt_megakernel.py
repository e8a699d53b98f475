"""The path-tracer kernel's plain version and tables against the JAX
package's K3 Pallas kernel (models/pt_megakernel.py, run in interpret mode as
its own tests run it on the CPU), and the port's dispatch on CPU tensors.
Image tolerance: torch_parity.assert_pt_close (at most 2% of pixels beyond
2e-3, mean abs difference <= 1e-4). The CUDA kernel itself is tested on the
card by tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu.models import pathtracer as jpt
from u_4a_2s_p3d_raytracer_template2_tpu.models.glsl_scene import (
    glsl_world as jax_glsl_world,
)
from u_4a_2s_p3d_raytracer_template2_tpu.models import pt_megakernel as jmk

import chip_smoke
from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import pathtracer as pt
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    pt_megakernel as mk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
    glsl_camera,
    glsl_world,
)
from test_pt_megakernel import tiny_world
from test_torch_pathtracer import camera_rays_np, t
from torch_parity import (  # one_torch_thread: an autouse fixture
    assert_pt_close,
    jax_pt_scene_to_port,
    one_torch_thread,
)

CPU = torch.device("cpu")


def test_plain_matches_jax_kernel_interpret():
    jw = tiny_world()
    jr, r = camera_rays_np(8, seed=5)
    cfg = dict(max_bounces=3)
    uni = np.random.default_rng(1).random((3, pt.N_UNIFORMS, 64), np.float32)
    trace = jmk.trace_rays_megakernel(jw, jpt.PTConfig(**cfg),
                                      interpret=True, sub=8)
    want = trace(jr.origin, jr.direction, jr.time, jnp.asarray(uni))
    tables = mk.pt_tables(jax_pt_scene_to_port(jw))
    got = mk.trace_rays_plain(tables, r.origin, r.direction, r.time, t(uni),
                              pt.PTConfig(**cfg))
    assert_pt_close(got.numpy(), want)
    assert float(got.std()) > 0.05


def test_tiny_world_of_the_smoke_script_equals_jax():
    got = chip_smoke.tiny_pt_world(CPU)
    want = jax_pt_scene_to_port(tiny_world())
    for f in dataclasses.fields(pt.PTScene):
        if not f.compare:
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        pairs = ([(getattr(a, g.name), getattr(b, g.name))
                  for g in dataclasses.fields(a)]
                 if f.name == "materials" else [(a, b)])
        for x, y in pairs:
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


def test_tables_drop_padding_and_keep_the_image():
    world = glsl_world(device=CPU)
    tables = mk.pt_tables(world)
    assert (tables.n_sph, tables.n_tri, tables.n_lights) == (102, 2, 3)
    assert world.sp_radius.shape[0] == 104 and world.tri_v0.shape[0] == 8
    assert tables.tbl.shape == (104 * mk.ROW_W,)
    assert mk.pt_tables(world) is tables  # packed once per scene
    assert mk.supports(world)
    assert jmk.supports(jax_glsl_world())  # the K3 ceilings agree

    g = torch.Generator().manual_seed(3)
    cfg = pt.PTConfig(max_bounces=3)
    rays = pt.camera_rays(glsl_camera(8, 8, device=CPU), g)
    uni = pt.draw_uniforms(g, 3, 64)
    again = mk.scene_from_tables(tables)
    np.testing.assert_array_equal(
        pt.ray_color_presampled(again, cfg, rays, uni).numpy(),
        pt.ray_color_presampled(world, cfg, rays, uni).numpy())
    # the work that sets the kernel's bound in chip_smoke.py, on the same
    # inputs: every live path tests all 104 rows, each facing (hit, light)
    # pair casts a feeler that tests rows up to its first occluder
    w = chip_smoke.pt_work(again, cfg, rays, uni)
    alive = w["alive"]
    assert alive[0] == 64 and alive == sorted(alive, reverse=True)
    assert len(alive) <= cfg.max_bounces and w["tests"] == sum(alive)
    assert 0 < w["hits"] <= w["tests"] and w["pairs"] == 3 * w["hits"]
    assert 0 < w["feelers"] <= w["pairs"]
    assert w["feelers"] <= w["sph_tests"] + w["tri_tests"]
    assert w["sph_tests"] <= 102 * w["feelers"]
    assert w["tri_tests"] <= 2 * w["feelers"]


def test_first_hit_tests_stop_at_the_first_occluder():
    occ = torch.tensor([[0, 1, 0, 1, 0], [0, 0, 0, 0, 1], [0, 0, 0, 0, 0],
                        [1, 1, 1, 1, 1]], dtype=torch.bool)
    # stops after 2, 5, 5 and 1 tests: spheres first (4 rows), then 1 tri
    assert chip_smoke.first_hit_tests(occ, (4, 1)) == [2 + 4 + 4 + 1, 2]
    assert chip_smoke.first_hit_tests(occ[:0], (4, 1)) == [0, 0]
    assert chip_smoke.first_hit_tests(occ[:, :0], (0, 0)) == [0, 0]


def test_render_frame_engines_agree_on_cpu():
    world = chip_smoke.tiny_pt_world(CPU)
    cam = chip_smoke.pt_time_span(glsl_camera(6, 6, device=CPU))
    cfg = pt.PTConfig(max_bounces=4, russian_roulette=True)
    before = kernels.pt_megakernel.launches
    frames = [mk.make_render_frame(world, cam, cfg, engine)(
        torch.Generator().manual_seed(9)) for engine in mk.ENGINES]
    assert kernels.pt_megakernel.launches == before  # CPU: plain only
    assert frames[0].shape == (6, 6, 3)
    assert torch.equal(frames[0], frames[1])
    # both draw what chip_smoke.pt_inputs draws: rays, then [B, 11, R]
    o, d, tm, uni = chip_smoke.pt_inputs(cam, cfg, 9, CPU)
    assert uni.shape == (4, pt.N_UNIFORMS, 36)
    want = mk.trace_rays_plain(mk.pt_tables(world), o, d, tm, uni, cfg)
    assert torch.equal(frames[0], want.reshape(6, 6, 3))
    assert torch.equal(
        pt.render_frame(world, cam, cfg, torch.Generator().manual_seed(9)),
        frames[0])
    with pytest.raises(ValueError, match="engine"):
        mk.make_render_frame(world, cam, cfg, "xla")


def test_ceilings_raise_for_the_kernel_only():
    n = mk.MAX_SPHERES + 1
    big = dataclasses.replace(
        glsl_world(device=CPU),
        sp_center0=torch.zeros(n, 3), sp_center1=torch.zeros(n, 3),
        sp_radius=torch.full((n,), 0.1), sp_time0=torch.zeros(n),
        sp_time1=torch.zeros(n), sp_mat=torch.zeros(n, dtype=torch.int32))
    assert not mk.supports(big)
    cam = glsl_camera(2, 2, device=CPU)
    with pytest.raises(NotImplementedError, match="plain"):
        mk.make_render_frame(big, cam, pt.PTConfig(), "megakernel")
    frame = mk.make_render_frame(big, cam, pt.PTConfig(max_bounces=1),
                                 "plain")(torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(frame).all())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: CPU tensors raise before any build."""
    tables = mk.pt_tables(glsl_world(device=CPU))
    o = torch.zeros(16, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pt_megakernel(tables, o, o, torch.zeros(16),
                              torch.zeros(1, pt.N_UNIFORMS, 16),
                              pt.PTConfig())
