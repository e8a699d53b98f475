"""The port's distribution mode against the JAX package's: the spp×spp
anti-aliasing scan (with and without ``reference_aa_div16``), thin-lens
depth of field and motion blur, fed the JAX package's own draws.

PyTorch cannot reproduce threefry, so ``torch_parity.jax_draws`` re-derives
the raw uniforms of JAX's ``render_tile`` from its key chain and hands them
to the port as its sample plan (models/samples.py); the images are then
held to the repo's rule, ``assert_images_close`` (atol 2e-3 on all but 1%
of pixels). Rays are held to 1e-5 (the sin/cos of the lens sample differ by
an ulp between the two libraries).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.models.whitted import (
    render_tile as jax_render_tile,
)
from u_4a_2s_p3d_raytracer_template2_tpu.ops.camera import (
    primary_rays as jax_primary_rays,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.cli import main as cli_main
from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.skybox import (
    save_skybox_dir,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import samples, scenes
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import whitted as pw
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import primary_rays
from conftest import assert_images_close
from torch_parity import (  # one_torch_thread: an autouse fixture
    jax_draws,
    jax_reference,
    jax_scene_to_port,
    mixed_scene,
    one_torch_thread,
)

CPU = torch.device("cpu")
RES = 12


def _pixels(res):
    ys, xs = np.meshgrid(np.arange(res, dtype=np.float32),
                         np.arange(res, dtype=np.float32), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _jax_scene(res=RES, aperture_ratio=2.0):
    sd = mixed_scene(rt.SceneDef(), res=res)
    sd.camera["aperture_ratio"] = aperture_ratio
    return rt.build_scene(sd)


def sweep_against_jax(jscene, flags, depth, seed, res=RES):
    """The port's sweep (render_tile) on JAX's draws against JAX's
    render_tile on the same key, both on every pixel of the frame."""
    key = jax.random.PRNGKey(seed)
    px, py = _pixels(res)
    cfg = rt.RenderConfig(max_depth=depth, **flags)
    want = jax_reference(
        lambda x, y, k: jax_render_tile(jscene, x, y, cfg, k),
        jnp.asarray(px), jnp.asarray(py), key)
    port = jax_scene_to_port(jscene)
    pcfg = pt.RenderConfig(max_depth=depth, **flags)
    draws = jax_draws(key, samples.scene_layout(port, pcfg), pcfg, res * res)
    got = pw.render_tile(port, torch.from_numpy(px), torch.from_numpy(py),
                         pcfg, draws=draws).numpy()
    assert np.isfinite(got).all()
    assert_images_close(got.reshape(res, res, 3), want.reshape(res, res, 3))
    return got


@pytest.mark.parametrize("flags", [
    dict(anti_aliasing=True, spp=2),
    dict(anti_aliasing=True, spp=2, reference_aa_div16=True),
    dict(anti_aliasing=True, spp=2, depth_of_field=True),
    dict(motion_blur=True, depth_of_field=True),
], ids=["aa", "aa_div16", "aa_dof", "motion_blur_dof"])
def test_sweep_matches_jax_render_tile(flags):
    sweep_against_jax(_jax_scene(), flags, depth=2, seed=3)


def test_primary_rays_match_jax():
    """Thin-lens rays with shutter times from the same raw draws."""
    jscene = _jax_scene()
    port = jax_scene_to_port(jscene)
    cfg = pt.RenderConfig(depth_of_field=True, motion_blur=True)
    key = jax.random.PRNGKey(9)
    [d] = jax_draws(key, samples.scene_layout(port, cfg), cfg, RES * RES)
    px, py = _pixels(RES)
    kcam = jax.random.split(key, 3)[1]  # render_tile's split without AA
    want = jax_primary_rays(jscene.camera, jnp.asarray(px + 0.5),
                            jnp.asarray(py + 0.5), kcam,
                            depth_of_field=True, motion_blur=True)
    got = primary_rays(port.camera, torch.from_numpy(px + 0.5),
                       torch.from_numpy(py + 0.5), depth_of_field=True,
                       motion_blur=True, time_u=d.time, lens_u=d.lens)
    for g, w in ((got.origin, want.origin), (got.direction, want.direction),
                 (got.time, want.time)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    with pytest.raises(ValueError, match="lens"):
        primary_rays(port.camera, torch.zeros(2), torch.zeros(2),
                     depth_of_field=True)


def test_every_config_is_served():
    """check_config opens for every distribution flag on all three
    engines; only an engine the port does not have raises."""
    for field in ("anti_aliasing", "depth_of_field", "motion_blur",
                  "fuzzy_reflection", "soft_shadow", "use_skybox"):
        for engine in ("sweep", "wavefront", "megakernel"):
            pw.check_config(pt.RenderConfig(engine=engine, **{field: True}))
    with pytest.raises(ValueError, match="engine"):
        pw.check_config(pt.RenderConfig(engine="packets"))


@pytest.mark.parametrize("field", ["anti_aliasing", "depth_of_field",
                                   "motion_blur", "fuzzy_reflection"])
def test_distribution_configs_render_on_both_engines(field):
    """Each flag renders on the sweep and on the megakernel engine's plain
    version, the same image from the same generator seed (atol 1e-5: the
    two trace the same rows in another order of operations)."""
    scene = pt.build_scene(mixed_scene(pt.SceneDef(), res=4), device=CPU)
    imgs = [pt.render_image(scene, pt.RenderConfig(engine=engine,
                                                   **{field: True}),
                            torch.Generator().manual_seed(1))
            for engine in ("sweep", "megakernel")]
    for img in imgs:
        assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
    torch.testing.assert_close(imgs[1], imgs[0], rtol=0, atol=1e-5)


def test_render_image_tiles_and_generator():
    """Tiles split the frame as the JAX package's render_image does; a
    deterministic config gives the same image in any tiling, and a
    stochastic one the same image from the same generator seed."""
    scene = pt.build_scene(mixed_scene(pt.SceneDef(), res=8), device=CPU)
    cfg = pt.RenderConfig(max_depth=2)
    whole = pt.render_image(scene, cfg)
    assert torch.equal(pt.render_image(scene, cfg, tile_rows=3), whole)
    dist = dataclasses.replace(cfg, anti_aliasing=True, spp=2,
                               soft_shadow=True, fuzzy_reflection=True)
    a, b = (pt.render_image(scene, dist, torch.Generator().manual_seed(5),
                            tile_rows=3) for _ in range(2))
    assert torch.equal(a, b) and a.shape == (8, 8, 3)
    assert not torch.equal(a, pt.render_image(
        scene, dist, torch.Generator().manual_seed(6), tile_rows=3))


def test_cli_renders_a_p3f_with_env_and_spp(tmp_path, capsys):
    """A .p3f file with ``env`` and ``spp`` lines renders through the CLI:
    spp turns on AA and DoF, the cubemap loads from PNG faces."""
    env = tmp_path / "sky"
    save_skybox_dir(str(env), scenes.synthetic_skybox(8, seed=1))
    scene_dir = tmp_path / "scenes"
    scene_dir.mkdir()
    p3f = scene_dir / "tiny.p3f"
    p3f.write_text(
        "v from 0 1 6 at 0 0 0 up 0 1 0 angle 40 hither 0.01 resolution 8 8"
        " aperture 2 focal 1\n"
        "bclr 0.2 0.3 0.5\n"
        "env sky\n"
        "spp 2\n"
        "l 4 6 4 1 1 1\n"
        "f 0.7 0.3 0.2 1 1 1 1 0.5 40 0 1\n"
        "s 0 0 0 1\n"
        "f 0.9 0.9 0.9 0.1 1 1 1 0.1 100 1 1.5\n"
        "s 1.2 0.2 1 0.5\n")
    out = tmp_path / "out.png"
    assert cli_main(["render", str(p3f), "--device", "cpu", "--depth", "3",
                     "--soft-shadow", "--fuzzy-reflection", "--skybox",
                     "--engine", "megakernel", "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "4 samples a pixel (AA True, DoF True" in text
    assert "skybox (6, 8, 8, 3) torch.uint8" in text
    assert out.exists()


def test_cli_renders_the_distribution_builtin(tmp_path, capsys):
    """``--builtin mount_dist`` is mount_low in distribution mode: spp 4
    turns on AA and DoF (16 samples a pixel) through an 8-pixel lens, and
    ``--env`` gives its cubemap."""
    env = tmp_path / "sky"
    save_skybox_dir(str(env), scenes.synthetic_skybox(8, seed=2))
    out = tmp_path / "dist.png"
    assert cli_main(["render", "--builtin", "mount_dist", "--res", "8",
                     "--depth", "2", "--soft-shadow", "--fuzzy-reflection",
                     "--skybox", "--env", str(env), "--device", "cpu",
                     "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "16 samples a pixel (AA True, DoF True" in text
    assert "skybox (6, 8, 8, 3) torch.uint8" in text
    assert out.exists()
    sd = scenes.mount_distribution_scene(8)
    assert sd.camera["aperture_ratio"] == scenes.DISTRIBUTION_APERTURE_RATIO
