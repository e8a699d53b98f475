"""The port's sweep engine against the JAX package's and against the scalar
oracle (tests/oracle.py), with the repo's image tolerance
(conftest.assert_images_close: atol 2e-3 on all but 1% of pixels). The
mode grid is that of tests/test_whitted_vs_oracle.py: every Fresnel mode x
refraction mode x shadow bound, on the four-primitive-type scene."""
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.models import scenes as jscenes
from conftest import assert_images_close
from oracle import Oracle
from test_whitted_vs_oracle import sphere_plane_scene
from torch_parity import (  # one_torch_thread: an autouse fixture
    jax_render_image,
    jax_scene_to_port,
    mixed_scene,
    one_torch_thread,
)


def _render_both(sd, **cfg):
    jscene = rt.build_scene(sd)
    want = jax_render_image(jscene, rt.RenderConfig(**cfg))
    got = pt.render_image(jax_scene_to_port(jscene), pt.RenderConfig(**cfg))
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_sweep_matches_jax_mount(depth):
    # 16x16, the other renders' size: the JAX reference runs op by op, and
    # ops of one shape compile once for every scene of this file
    got, want = _render_both(jscenes.mount_scene(res=16), max_depth=depth)
    assert_images_close(got, want)


def _diffuse_scene():
    sd = rt.SceneDef()
    sd.set_camera(eye=[0, 1, 5], at=[0, 0, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=16, res_y=16, aperture_ratio=0,
                  focal_ratio=1)
    m = sd.add_material([0.8, 0.3, 0.2], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    sd.add_sphere([0, 0, 0], 1.0, m)
    sd.add_plane_points([0, -1, 0], [1, -1, 0], [0, -1, -1], m)
    sd.add_light([5, 5, 5], [1, 1, 1])
    sd.bg_color = np.array([0.2, 0.2, 0.2], np.float32)
    return sd


@pytest.mark.parametrize("scene", ["reflective_only", "diffuse_only"])
def test_sweep_matches_jax_pruned_trees(scene):
    """A reflection chain (no transmissive material) and a single level (no
    secondary rays at all), with two lights and a plane."""
    sd = sphere_plane_scene(res=16) if scene == "reflective_only" \
        else _diffuse_scene()
    got, want = _render_both(sd, max_depth=3)
    assert_images_close(got, want)


@pytest.mark.parametrize("fresnel", ["schlick", "reference_schlick",
                                     "reference_exact"])
@pytest.mark.parametrize("refraction", ["reference", "physical"])
@pytest.mark.parametrize("unbounded", [False, True])
def test_sweep_matches_jax_mixed_modes(fresnel, refraction, unbounded):
    got, want = _render_both(mixed_scene(rt.SceneDef(), res=16), max_depth=2,
                             fresnel_mode=fresnel, refraction_mode=refraction,
                             shadow_unbounded=unbounded)
    assert_images_close(got, want)


@pytest.mark.parametrize("soft_shadow", [False, True])
def test_sweep_matches_oracle(soft_shadow):
    sd = mixed_scene(pt.SceneDef(), res=16)
    cfg = pt.RenderConfig(max_depth=3, soft_shadow=soft_shadow)
    img = pt.render_image(pt.build_scene(sd, device=torch.device("cpu")), cfg)
    assert_images_close(img.numpy(), Oracle(sd, cfg).render())


@pytest.mark.parametrize("field", ["anti_aliasing", "depth_of_field",
                                   "motion_blur", "fuzzy_reflection"])
def test_distribution_configs_on_wavefront_and_perray(field):
    """With a distribution flag on, the wavefront engine draws the same
    plan as the sweep from one generator seed and gives its image, and the
    per-ray BVH walk on a BVH scene gives the CUDA walk's plain version's
    image."""
    sd = mixed_scene(pt.SceneDef(), res=6)
    scene = pt.build_scene(sd, device=torch.device("cpu"))
    want = pt.render_image(scene, pt.RenderConfig(**{field: True}),
                           torch.Generator().manual_seed(1))
    got = pt.render_image(scene, pt.RenderConfig(engine="wavefront",
                                                 **{field: True}),
                          torch.Generator().manual_seed(1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4)
    bvh = pt.build_scene(sd, device=torch.device("cpu"), accel=2)
    walk = pt.render_image(bvh, pt.RenderConfig(**{field: True}),
                           torch.Generator().manual_seed(1))
    perray = pt.render_image(bvh, pt.RenderConfig(accel_impl="perray",
                                                  **{field: True}),
                             torch.Generator().manual_seed(1))
    np.testing.assert_allclose(perray.numpy(), walk.numpy(), atol=1e-5)


def test_wavefront_engine_renders():
    scene = pt.build_scene(mixed_scene(pt.SceneDef(), res=4),
                           device=torch.device("cpu"))
    got = pt.render_image(scene, pt.RenderConfig(engine="wavefront"))
    want = pt.render_image(scene, pt.RenderConfig())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4)
    with pytest.raises(ValueError, match="engine"):
        pt.render_image(scene, pt.RenderConfig(engine="fast"))
