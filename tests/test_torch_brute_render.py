"""The brute-force slice as a whole: the port's render_image of scenes with
at least 1,024 primitives of one type under ACCEL_NONE, on the CPU (the
kernels' plain version), against the JAX package's render_image (the
repo's image rule, conftest.assert_images_close); and the dispatch of
models/whitted.py and ops/intersect.py: dead lanes reach brute force, and
CPU tensors never reach the CUDA kernels' wrappers.

On the CPU JAX takes its XLA brute-force path in these renders; its Pallas
kernels K4a-K4e are held in tests/test_torch_brute_kernels.py.
"""
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.models import scenes as jscenes
from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect
from conftest import assert_images_close
from torch_parity import (  # one_torch_thread: an autouse fixture
    one_torch_thread,
    soup,
)

CPU = torch.device("cpu")


@pytest.fixture
def no_kernels(monkeypatch):
    """The CUDA kernels' wrappers raise if called: on CPU tensors the
    dispatch must take the plain version."""
    def refuse(*a, **k):
        raise AssertionError("a CPU render reached a CUDA kernel's wrapper")

    monkeypatch.setattr(kernels, "brute_closest", refuse)
    monkeypatch.setattr(kernels, "brute_any", refuse)


# (port SceneDef, JAX SceneDef, max_depth of both): the sphere field of
# 1,024 spheres at 16x16, depth 4; 1,100 triangles at 16x16, depth 2
SCENES = {
    "field1024": (lambda: scenes.sphere_field_scene(n_side=32, res=16),
                  lambda: jscenes.sphere_field_scene(n_side=32, res=16), 4),
    "triangles1100": (lambda: soup(pt.SceneDef(), 0, 1100),
                      lambda: soup(rt.SceneDef(), 0, 1100), 2),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_brute_render_matches_jax(name, no_kernels):
    port_sd, jax_sd, depth = SCENES[name]
    scene = pt.build_scene(port_sd(), device=CPU, accel=C.ACCEL_NONE)
    assert max(scene.prims.n_sph, scene.prims.n_tri) >= 1024
    img = pt.render_image(scene, pt.RenderConfig(max_depth=depth))
    # the JAX package's jitted brute-force render
    want = rt.render_image(rt.build_scene(jax_sd(), accel=C.ACCEL_NONE),
                           rt.RenderConfig(max_depth=depth))
    assert_images_close(img.numpy(), np.asarray(want))


def test_brute_shadow_queries_pass_dead_lanes(monkeypatch, no_kernels):
    """direct_lighting hands brute force ~(active & facing), as it hands
    the walk; those lanes report occluded, and the image equals the BVH
    walk's, bit for bit."""
    sd = scenes.sphere_field_scene(n_side=8, res=16)
    scene = pt.build_scene(sd, device=CPU, accel=C.ACCEL_NONE)
    assert intersect._small_total(scene.prims) > intersect.SMALL_UNROLL_MAX
    seen = []
    any_hit = intersect.any_hit_brute

    def record(prims, rays, max_t, dead=None, tables=None):
        seen.append(dead)
        occ = any_hit(prims, rays, max_t, dead, tables)
        assert bool(occ[dead].all())
        return occ

    monkeypatch.setattr(intersect, "any_hit_brute", record)
    img = pt.render_image(scene, pt.RenderConfig(max_depth=3))
    assert len(seen) == 3 * scene.n_lights
    assert all(d is not None for d in seen)
    assert any(bool(d.any()) and not bool(d.all()) for d in seen)
    bvh = pt.build_scene(sd, device=CPU)
    assert torch.equal(img, pt.render_image(bvh, pt.RenderConfig(
        max_depth=3)))
    assert torch.equal(img, pt.render_image(bvh, pt.RenderConfig(
        max_depth=3, accel_impl="brute")))


def test_cli_renders_brute_scenes_on_cpu(tmp_path, capsys, monkeypatch,
                                        no_kernels):
    """cli render --builtin spheres --accel 0 (258 primitives) reaches the
    brute-force dispatch; on the CPU it runs the plain version."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import cli

    calls = []
    closest = intersect.closest_hit_plain
    monkeypatch.setattr(intersect, "closest_hit_plain",
                        lambda *a: calls.append(1) or closest(*a))
    assert cli.main(["render", "--builtin", "spheres", "--accel", "0",
                     "--res", "8", "--depth", "2", "--device", "cpu", "-o",
                     str(tmp_path / "s.png")]) == 0
    assert "accel none" in capsys.readouterr().out
    assert len(calls) == 2 and (tmp_path / "s.png").exists()
