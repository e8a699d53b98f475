"""The megakernel's plain version against the JAX package's operand-streamed
Pallas kernel (models/whitted_streamed.py, run in interpret mode as its own
tests run it on the CPU), and the port's megakernel dispatch on CPU
tensors. Image tolerance: conftest.assert_images_close (atol 2e-3 on all
but 1% of pixels). The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.models import scenes as jscenes
from u_4a_2s_p3d_raytracer_template2_tpu.models.whitted_streamed import (
    trace_rays_streamed,
)
from u_4a_2s_p3d_raytracer_template2_tpu.ops.camera import (
    pinhole_rays as jax_pinhole_rays,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_megakernel as mk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    mount_scene,
    sphere_field_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    pixel_grid,
    render_tile,
)
from conftest import assert_images_close
from torch_parity import jax_scene_to_port, mixed_scene

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["mount", "mixed"])
def test_plain_matches_jax_streamed_kernel_interpret(name):
    res = 16
    sd = (jscenes.mount_scene(res=res) if name == "mount"
          else mixed_scene(rt.SceneDef(), res=res))
    jscene = rt.build_scene(sd)
    px, py = (a.numpy() for a in pixel_grid(res, res, CPU))
    jrays = jax_pinhole_rays(jscene.camera, px + 0.5, py + 0.5)
    cfg = dict(max_depth=2)
    want = np.asarray(trace_rays_streamed(
        jscene, jrays, rt.RenderConfig(**cfg), jax.random.PRNGKey(0),
        impl="interpret"))
    rays = Rays.make(torch.from_numpy(np.array(jrays.origin)),
                     torch.from_numpy(np.array(jrays.direction)))
    got = mk.trace_rays_megakernel(jax_scene_to_port(jscene), rays,
                                   pt.RenderConfig(engine="megakernel", **cfg))
    assert_images_close(got.numpy().reshape(res, res, 3),
                        want.reshape(res, res, 3))


@pytest.mark.parametrize("name,depth", [("mount", 4), ("mixed", 3),
                                        ("sphere_field", 2)])
def test_render_tile_megakernel_on_cpu_equals_sweep(name, depth):
    sd = {"mount": lambda: mount_scene(res=16),
          "mixed": lambda: mixed_scene(pt.SceneDef(), res=16),
          "sphere_field": lambda: sphere_field_scene(
              n_side=8, res=16, accel=C.ACCEL_NONE)}[name]()
    scene = pt.build_scene(sd, device=CPU)
    px, py = pixel_grid(16, 16, CPU)
    before = kernels.whitted_megakernel.launches
    got = render_tile(scene, px, py,
                      pt.RenderConfig(max_depth=depth, engine="megakernel"))
    want = render_tile(scene, px, py, pt.RenderConfig(max_depth=depth))
    assert kernels.whitted_megakernel.launches == before  # CPU: plain only
    assert_images_close(got.numpy().reshape(16, 16, 3),
                        want.numpy().reshape(16, 16, 3))


def test_reconstruct_scene_round_trips_tables():
    scene = pt.build_scene(mixed_scene(pt.SceneDef(), res=8), device=CPU)
    tables = mk.scene_tables(scene)
    again = mk.scene_tables(mk.reconstruct_scene(mk.shape_of(scene), *tables))
    for a, b in zip(tables, again):
        assert torch.equal(a, b)
    assert tables[0].shape == (mk.shape_of(scene).n * mk.TBL_W,)
    # packed once per scene; a replaced scene packs its own
    assert mk.scene_tables(scene) is tables
    moved = dataclasses.replace(scene, bg_color=scene.bg_color + 0.5)
    assert torch.equal(mk.scene_tables(moved)[2], tables[2] + 0.5)


def test_envelope_raises():
    big = pt.build_scene(sphere_field_scene(n_side=16, res=4,
                                            accel=C.ACCEL_NONE), device=CPU)
    assert big.n_objects > mk.MAX_PRIMS
    cfg = pt.RenderConfig(engine="megakernel")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mk.check_supported(big, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.render_image(big, cfg)
    small = pt.build_scene(mount_scene(res=4), device=CPU)
    mk.check_supported(small, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.render_image(small, pt.RenderConfig(engine="megakernel",
                                               max_depth=mk.MAX_DEPTH + 1))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: CPU tensors raise before any build."""
    scene = pt.build_scene(mount_scene(res=4), device=CPU)
    tbl, lt, bg = mk.scene_tables(scene)
    o = torch.zeros(16, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.whitted_megakernel(tbl, lt, bg, o, o, mk.shape_of(scene),
                                   pt.RenderConfig())


def test_whitted_work_counts_the_kernels_walk():
    """The work that sets the kernel's bound in chip_smoke.py: every node
    tests all 12 primitives of mount_low; each (hit, light) pair that faces
    the light casts a shadow ray that tests primitives up to its first
    occluder."""
    import chip_smoke
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        pinhole_rays,
    )

    scene = pt.build_scene(mount_scene(res=16), device=CPU)
    px, py = pixel_grid(16, 16, CPU)
    r = pinhole_rays(scene.camera, px + 0.5, py + 0.5)
    w = chip_smoke.whitted_work(scene, r.origin, r.direction,
                                pt.RenderConfig(engine="megakernel"))
    assert 256 <= w["tests"] <= 256 * 4
    assert 0 < w["hits"] <= w["tests"] and w["pairs"] == w["hits"]
    assert 0 < w["feelers"] < w["pairs"]  # some hits face away
    tests = w["tri_tests"] + w["sph_tests"]
    assert w["feelers"] <= tests < 12 * w["feelers"]  # some stop early
    assert w["tri_tests"] <= 8 * w["feelers"]
    assert w["sph_tests"] <= 4 * w["feelers"]
    with pytest.raises(NotImplementedError, match="point lights"):
        chip_smoke.whitted_work(scene, r.origin, r.direction,
                                pt.RenderConfig(soft_shadow=True))
