"""Pins where the port's sharded loss departs from JAX's: JAX pads the
pixel list to a multiple of the mesh with pixel (0, 0) against a zero
target (JAX parallel/dist.py:52-57, :114-117, :292-295), so when the pixel
count is not a multiple of the devices its loss and gradients count a
phantom pixel. The port shards without padding (parallel/dist
.shard_bounds).

The case: tests/test_whitted_vs_oracle.py's sphere_plane_scene at 5x5 (25
pixels), the target the scene's own render, train_step at lr 0 on two
ranks. The port's loss is 0; JAX's on a mesh of 2 is 0.0531237, which is
|img(0, 0)|² · 1 / 25, the one padded pixel (measured on an 8-core x86
host: 0 on a mesh of 1, 0.3718657 on a mesh of 8, 7 padded pixels).
"""
import jax
import numpy as np
import pytest

import u_4a_2s_p3d_raytracer_template2_tpu as jrt
from u_4a_2s_p3d_raytracer_template2_tpu.models.whitted import (
    render_image as jax_render_image,
)
from u_4a_2s_p3d_raytracer_template2_tpu.parallel import dist as jdist

from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import launch

import torch_dist_workers as workers
from test_whitted_vs_oracle import sphere_plane_scene
from torch_parity import jax_reference, one_torch_thread  # noqa: F401

JAX_MESH2_LOSS = 0.0531237


@pytest.fixture(scope="module")
def jax_loss():
    """JAX's train_step on 2 of the 8 virtual CPU devices, the target its
    own render (one program, XLA level 0)."""
    mesh = jdist.default_mesh(2)
    cfg = jrt.RenderConfig()

    def loss(s):
        return jdist.train_step(s, jax_render_image(s, cfg), cfg, mesh, 0.0,
                                jax.random.PRNGKey(0))[1]

    return float(jax_reference(loss, jrt.build_scene(sphere_plane_scene(
        res=5))))


def test_port_has_no_phantom_pixel():
    losses = launch.run(workers.pin_rank, 2, timeout_s=90.0)
    assert losses == [0.0, 0.0]


def test_jax_counts_pixel_zero_twice(jax_loss):
    np.testing.assert_allclose(jax_loss, JAX_MESH2_LOSS, rtol=1e-5)
    _, target = workers.pin_scene()
    phantom = float((target[0, 0] ** 2).sum()) / 25.0
    np.testing.assert_allclose(jax_loss, phantom, rtol=1e-5)
