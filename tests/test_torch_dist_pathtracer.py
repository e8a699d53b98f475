"""The port's sharded path-traced frame (parallel/dist.pt_frame_sharded)
on two gloo ranks on the CPU: glsl_world at 16x16, 3 bounces (the case of
tests/test_parallel.py::test_pathtracer_sharded_frame).

Each rank draws its pixels' camera samples and uniforms from its own
generator (dist.rank_generator) and traces them with the path-tracer
kernel's entry point (its plain version on CPU tensors), so each rank's
slice of the gathered frame equals a single-process trace of that rank's
draws exactly. Against JAX's sharded frame on a mesh of 2, whose draws
differ, the means agree within tests/test_parallel.py's 0.35.
"""
import jax
import numpy as np
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu.models.glsl_scene import (
    glsl_camera as jax_glsl_camera,
    glsl_world as jax_glsl_world,
)
from u_4a_2s_p3d_raytracer_template2_tpu.models.pathtracer import (
    PTConfig as JaxPTConfig,
)
from u_4a_2s_p3d_raytracer_template2_tpu.parallel import dist as jdist

from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import pathtracer as pt
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    pt_megakernel as ptk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
    glsl_camera,
    glsl_world,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    pixel_grid,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist, launch

import torch_dist_workers as workers
from torch_parity import one_torch_thread  # noqa: F401

RES, BOUNCES = 16, 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def frames():
    return launch.run(workers.pt_rank, 2, RES, BOUNCES, timeout_s=90.0)


def test_ranks_hold_the_same_finite_frame(frames):
    a, b = frames
    assert a.shape == (RES, RES, 3) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b)


def test_each_slice_is_its_ranks_draws_traced(frames):
    torch.set_num_threads(1)
    world = glsl_world(device=CPU)
    cam = glsl_camera(RES, RES, device=CPU)
    cfg = pt.PTConfig(max_bounces=BOUNCES)
    px, py = pixel_grid(RES, RES, CPU)
    flat = frames[0].reshape(-1, 3)
    jitters = []
    for r in range(2):
        a, b = dist.shard_bounds(RES * RES, 2, r)
        g = dist.rank_generator(None, r, 2, CPU)
        rays = pt.camera_rays(cam, g, px[a:b], py[a:b])
        uni = pt.draw_uniforms(g, BOUNCES, b - a)
        want = ptk.trace_rays_megakernel(ptk.pt_tables(world), rays.origin,
                                         rays.direction, rays.time, uni, cfg)
        assert torch.equal(flat[a:b], want), r
        jitters.append(rays.direction)
    assert not torch.equal(jitters[0], jitters[1])


def test_world_one_is_the_render_frame():
    torch.set_num_threads(1)
    world = glsl_world(device=CPU)
    cam = glsl_camera(RES, RES, device=CPU)
    cfg = pt.PTConfig(max_bounces=BOUNCES)
    got = dist.pt_frame_sharded(world, cam, cfg, None,
                                torch.Generator().manual_seed(4))
    want = ptk.make_render_frame(world, cam, cfg)(
        torch.Generator().manual_seed(4))
    assert torch.equal(got, want)


def test_mean_against_jax_sharded(frames):
    mesh = jdist.default_mesh(2)
    want = np.asarray(jdist.pt_frame_sharded(
        jax_glsl_world(), jax_glsl_camera(RES, RES),
        JaxPTConfig(max_bounces=BOUNCES), mesh, jax.random.PRNGKey(0)))
    assert np.isfinite(want).all()
    assert abs(float(frames[0].mean()) - float(want.mean())) < 0.35


def test_world_one_plain_engine_is_the_plain_frame():
    torch.set_num_threads(1)
    world = glsl_world(device=CPU)
    cam = glsl_camera(8, 8, device=CPU)
    cfg = pt.PTConfig(max_bounces=2)
    got = dist.pt_frame_sharded(world, cam, cfg, None,
                                torch.Generator().manual_seed(9), "plain")
    want = pt.render_frame(world, cam, cfg, torch.Generator().manual_seed(9))
    assert torch.equal(got, want)
