"""The BVH path of the port's sweep engine: images of BVH (and grid) scenes
against brute force, in the port (exactly: same formulas, same ties) and in
the JAX package (the repo's image rule, conftest.assert_images_close), and
the ``accel_impl`` dispatch of models/whitted.py."""
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.models import scenes as jscenes
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
from conftest import assert_images_close
from torch_parity import (  # one_torch_thread: an autouse fixture
    mixed_scene,
    one_torch_thread,
)

CPU = torch.device("cpu")

# (port SceneDef, JAX SceneDef): the field at 24x24, random_scene at 32x24
SCENES = {
    "field": (lambda: scenes.sphere_field_scene(n_side=16, res=24),
              lambda: jscenes.sphere_field_scene(n_side=16, res=24)),
    "random": (lambda: scenes.random_scene(32, 24),
               lambda: jscenes.random_scene(32, 24)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bvh_image_equals_brute_force_and_matches_jax(name):
    port_sd, jax_sd = SCENES[name]
    scene = pt.build_scene(port_sd(), device=CPU)
    assert scene.accel_type == C.ACCEL_BVH and scene.packets is not None
    cfg = pt.RenderConfig()
    img = pt.render_image(scene, cfg)
    brute = pt.render_image(pt.build_scene(port_sd(), device=CPU,
                                           accel=C.ACCEL_NONE), cfg)
    assert torch.equal(img, brute)
    # the JAX package's jitted brute-force render (one compile, about 6 s on
    # the CPU, where its op-by-op form takes about 40 s)
    want = rt.render_image(rt.build_scene(jax_sd(), accel=C.ACCEL_NONE),
                           rt.RenderConfig())
    assert_images_close(img.numpy(), np.asarray(want))


def _two_light_mixed(accel):
    sd = mixed_scene(pt.SceneDef(), res=16)
    sd.add_light([-5, 3, 2], [0.5, 0.4, 0.4])
    sd.accel_type = accel
    return sd


@pytest.mark.parametrize("soft_shadow", [False, True])
def test_every_accel_impl_gives_the_same_image(soft_shadow, monkeypatch):
    """All four primitive types, two lights: "auto", "packets", "clusters"
    and "multi" walk the tree, "brute" tests every primitive; "multi" fuses
    the hard shadows of both lights into one query per level."""
    scene = pt.build_scene(_two_light_mixed(C.ACCEL_BVH), device=CPU)
    calls = {"any": 0, "multi": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(packets, "packet_any_hit",
                        count("any", packets.packet_any_hit))
    monkeypatch.setattr(packets, "packet_any_hit_multi",
                        count("multi", packets.packet_any_hit_multi))
    want = pt.render_image(scene, pt.RenderConfig(
        accel_impl="brute", soft_shadow=soft_shadow, max_depth=3))
    assert calls == {"any": 0, "multi": 0}
    for impl in ("auto", "packets", "clusters", "multi"):
        got = pt.render_image(scene, pt.RenderConfig(
            accel_impl=impl, soft_shadow=soft_shadow, max_depth=3))
        assert torch.equal(got, want), impl
    # per level: 2 single queries per light (4x4 = 16 for soft shadows) in
    # each of the first three impls, and one fused query under "multi"
    per_level = 2 * (16 if soft_shadow else 1)
    multi = 0 if soft_shadow else 3
    assert calls == {"any": 3 * 3 * per_level + (3 * per_level if soft_shadow
                                                 else 0),
                     "multi": multi}


def test_shadow_queries_pass_dead_lanes(monkeypatch):
    """direct_lighting hands the walk ~(active & facing), as JAX does, so
    masked lanes are not walked; the image does not change."""
    scene = pt.build_scene(_two_light_mixed(C.ACCEL_BVH), device=CPU)
    seen = []

    def any_hit(pt_, rays, max_t, dead=None):
        seen.append(dead)
        return packets.any_hit_plain(pt_, rays.origin, rays.direction,
                                     max_t, dead)

    monkeypatch.setattr(packets, "packet_any_hit", any_hit)
    img = pt.render_image(scene, pt.RenderConfig(max_depth=2))
    assert seen and all(d is not None for d in seen)
    assert any(bool(d.any()) and not bool(d.all()) for d in seen)
    monkeypatch.undo()
    assert torch.equal(img, pt.render_image(scene, pt.RenderConfig(
        max_depth=2, accel_impl="brute")))


def test_grid_scene_routes_to_the_walk(monkeypatch):
    scene = pt.build_scene(_two_light_mixed(C.ACCEL_GRID), device=CPU)
    assert scene.accel_type == C.ACCEL_GRID and scene.packets is not None
    walked = []
    closest = packets.packet_closest_hit
    monkeypatch.setattr(packets, "packet_closest_hit",
                        lambda *a: walked.append(1) or closest(*a))
    img = pt.render_image(scene, pt.RenderConfig(max_depth=2))
    assert len(walked) == 2
    bvh = pt.build_scene(_two_light_mixed(C.ACCEL_BVH), device=CPU)
    assert torch.equal(img, pt.render_image(bvh, pt.RenderConfig(
        max_depth=2)))


def test_perray_and_grid_initfail_render():
    """accel_impl="perray" renders the BVH scene through the median-tree
    walk and the grid scene through the DDA, each with the walk's image;
    reference_grid_shadow_initfail renders under every accel_impl, its
    shadow queries on the DDA, with one image."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import traverse

    bvh = pt.build_scene(_two_light_mixed(C.ACCEL_BVH), device=CPU)
    grid = pt.build_scene(_two_light_mixed(C.ACCEL_GRID), device=CPU)
    cfg = pt.RenderConfig(max_depth=2)
    for scene in (bvh, grid):
        before = traverse.stats["queries"]
        img = pt.render_image(scene, pt.RenderConfig(max_depth=2,
                                                     accel_impl="perray"))
        assert traverse.stats["queries"] > before
        np.testing.assert_allclose(img.numpy(), pt.render_image(
            scene, cfg).numpy(), atol=1e-5)
    quirk = [pt.render_image(grid, pt.RenderConfig(
        max_depth=2, accel_impl=impl, reference_grid_shadow_initfail=True))
        for impl in ("auto", "multi", "brute", "perray")]
    for img in quirk[1:]:
        np.testing.assert_allclose(img.numpy(), quirk[0].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="accel_impl"):
        pt.render_image(bvh, pt.RenderConfig(accel_impl="fast"))


def test_cli_renders_bvh_scenes_on_cpu(tmp_path, capsys):
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import cli

    for builtin, impl in (("random", "auto"), ("spheres", "brute")):
        path = str(tmp_path / f"{builtin}.png")
        assert cli.main(["render", "--builtin", builtin, "--accel", "2",
                         "--accel-impl", impl, "--res", "8", "--depth", "2",
                         "--device", "cpu", "-o", path]) == 0
        assert f"accel bvh ({impl})" in capsys.readouterr().out
    assert cli.main(["render", "--builtin", "random", "--accel", "0",
                     "--res", "8", "--depth", "2", "--device", "cpu", "-o",
                     str(tmp_path / "none.png")]) == 0
    assert "accel none" in capsys.readouterr().out
    assert ((tmp_path / "random.png").read_bytes()
            == (tmp_path / "none.png").read_bytes())
