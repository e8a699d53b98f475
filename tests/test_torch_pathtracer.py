"""The port's path tracer (ops/glsl_hash, ops/sampling, thin_lens_rays,
models/glsl_scene, models/pathtracer, utils/checkpoint, cli pathtrace)
against the JAX package, on the same inputs made from numpy seeds.

Tolerances: scene tables and the uint hash exactly; cameras, samplers and
rays atol 1e-6 (``u.pow(1/3)`` stands in for ``jnp.cbrt``: a few ulp); hit
records, direct light and scatter atol 1e-5 (f32 reassociation: einsum and
cross products sum in another order); whole images by
``torch_parity.assert_pt_close``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu.core.types import Rays as JRays
from u_4a_2s_p3d_raytracer_template2_tpu.models import pathtracer as jpt
from u_4a_2s_p3d_raytracer_template2_tpu.models import glsl_scene as jgs
from u_4a_2s_p3d_raytracer_template2_tpu.ops import camera as jcam
from u_4a_2s_p3d_raytracer_template2_tpu.ops import glsl_hash as jhash
from u_4a_2s_p3d_raytracer_template2_tpu.ops import sampling as jsamp

from u_4a_2s_p3d_raytracer_template2_tpu_torch import cli
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import glsl_scene as gs
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import pathtracer as pt
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import camera
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import glsl_hash
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import sampling
from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import checkpoint
from test_pt_megakernel import tiny_world
from torch_parity import assert_pt_close, jax_pt_scene_to_port

CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_glsl_hash_bitwise():
    rng = np.random.default_rng(0)
    for px, py in rng.integers(0, 2**32, (64, 2), dtype=np.uint64):
        assert glsl_hash.base_hash(px, py) == jhash.base_hash(px, py)
    for seed in (0.0, 0.5, -3.004, 4.002):
        a, b = glsl_hash.SeedStream(seed), jhash.SeedStream(seed)
        for _ in range(5):
            assert a.hash1() == b.hash1()
            np.testing.assert_array_equal(a.hash2(), b.hash2())
            np.testing.assert_array_equal(a.hash3(), b.hash3())
        assert a.seed == b.seed


@pytest.mark.parametrize("flags", [
    {}, {"showcase_fuzzy_reflections": True},
    {"showcase_fuzzy_refractions": True}, {"no_negative_sphere": True}])
def test_glsl_world_equals_jax(flags):
    got = gs.glsl_world(device=CPU, **flags)
    want = jax_pt_scene_to_port(jgs.glsl_world(**flags))
    for f in dataclasses.fields(pt.PTScene):
        if not f.compare:
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        pairs = ([(getattr(a, g.name), getattr(b, g.name))
                  for g in dataclasses.fields(a)]
                 if f.name == "materials" else [(a, b)])
        for x, y in pairs:
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


@pytest.mark.parametrize("mode", [
    dict(), dict(orbit=True, mouse=(0.3, 0.6)), dict(showcase_dof=True)])
def test_glsl_camera_matches_jax(mode):
    got = gs.glsl_camera(24, 16, device=CPU, **mode)
    want = jgs.glsl_camera(24, 16, **mode)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, int):
            assert a == b
        else:
            close(a, b, 1e-6)


def test_sampling_and_thin_lens_match_jax():
    rng = np.random.default_rng(1)
    u = rng.random((3, 512), np.float32)
    u[:, 0] = 0.0
    tu = [t(x) for x in u]
    ju = [jnp.asarray(x) for x in u]
    close(sampling.disk_from_uniforms(*tu[:2]),
          jsamp.disk_from_uniforms(*ju[:2]), 1e-6)
    close(sampling.unit_sphere_from_uniforms(*tu),
          jsamp.unit_sphere_from_uniforms(*ju), 1e-6)
    close(sampling.unit_vector_from_uniforms(*tu),
          jsamp.unit_vector_from_uniforms(*ju), 1e-6)
    g = torch.Generator().manual_seed(0)
    assert sampling.sample_unit_sphere(g, (7,)).shape == (7, 3)
    assert float(sampling.sample_unit_vector(g, (9,)).norm(dim=-1).min()) > 0.99

    jc = jgs.glsl_camera(16, 8, showcase_dof=True)
    pc = gs.glsl_camera(16, 8, showcase_dof=True, device=CPU)
    px = rng.uniform(0, 16, 128).astype(np.float32)
    py = rng.uniform(0, 8, 128).astype(np.float32)
    lens = rng.uniform(-0.2, 0.2, (128, 2)).astype(np.float32)
    tm = rng.random(128, np.float32)
    got = camera.thin_lens_rays(pc, t(px), t(py), t(lens), t(tm))
    want = jcam.thin_lens_rays(jc, jnp.asarray(px), jnp.asarray(py),
                               jnp.asarray(lens), jnp.asarray(tm))
    close(got.origin, want.origin, 1e-6)
    close(got.direction, want.direction, 1e-6)
    close(got.time, want.time, 0)


def _tiny_rays(n, seed):
    """Rays from above the tiny world's ground, aimed down-ish, with
    shutter times."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, n), rng.uniform(0.3, 3, n),
                  rng.uniform(-3, 2, n)], -1).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:, 1] -= 0.5
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tm = rng.random(n, np.float32)
    return (JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)),
            Rays(t(o), t(d), t(tm)))


def test_hit_light_scatter_match_jax():
    jw = tiny_world()
    w = jax_pt_scene_to_port(jw)
    jr, r = _tiny_rays(256, 3)
    # jitted: one compile per function instead of one per op
    jh = jax.jit(jpt.hit_world)(jw, jr)
    h = pt.hit_world(w, r)
    assert h.hit.float().mean() > 0.5
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_array_equal(h.mat_id.numpy(), np.asarray(jh.mat_id))
    hit = h.hit.numpy()
    # at a grazing sphere hit (|n.d| small) the discriminant b*b - c is a
    # difference of two near-equal numbers, and its square root magnifies f32
    # reassociation: one of the 154 hits here, at |n.d| = 0.19 from 5 units
    # away, moves t by 3e-5 in both packages (float64 lies between). t and
    # the normal at sphere hits with |n.d| >= 0.25 and at triangle hits are
    # held to atol 1e-5.
    cos = np.abs((h.normal * r.direction).sum(-1).numpy())
    on_sphere = h.mat_id.numpy() != 6  # the triangles' material is 6
    firm = hit & ~(on_sphere & (cos < 0.25))
    assert firm.sum() > 0.9 * hit.sum()
    close(h.t.numpy()[firm], np.asarray(jh.t)[firm], 1e-5)
    close(h.normal.numpy()[firm], np.asarray(jh.normal)[firm], 1e-5)

    # direct light and scatter from one hit record, the port's
    jh = jpt.PTHit(*(jnp.asarray(x.numpy()) for x in (
        h.t, h.hit, h.point, h.normal, h.mat_id.int())))

    for len1 in (False, True):
        cfg = pt.PTConfig(reference_shadow_len1=len1)
        jcfg = jpt.PTConfig(reference_shadow_len1=len1)
        close(pt.direct_lighting(w, cfg, r, h, w.materials),
              jax.jit(jpt.direct_lighting, static_argnums=1)(
                  jw, jcfg, jr, jh, jw.materials), 1e-5)

    u = np.random.default_rng(4).random((11, 256), np.float32)
    nr, att, sc = pt.scatter_presampled(t(u), pt.PTConfig(), r, h,
                                        w.materials)
    jnr, jatt, jsc = jax.jit(jpt.scatter_presampled, static_argnums=1)(
        jnp.asarray(u), jpt.PTConfig(), jr, jh, jw.materials)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    close(nr.origin.numpy()[hit], np.asarray(jnr.origin)[hit], 1e-5)
    close(nr.direction.numpy()[hit], np.asarray(jnr.direction)[hit], 1e-5)
    close(att.numpy()[hit], np.asarray(jatt)[hit], 1e-5)


def camera_rays_np(res, seed, eye=(0.0, 2.0, 6.0)):
    """tests/test_pt_megakernel._rays with a numpy shutter time: pinhole
    pixel-center rays through the tiny world's camera, as (JAX, port)."""
    from u_4a_2s_p3d_raytracer_template2_tpu.core.build import build_camera

    cam = build_camera(dict(
        eye=np.array(eye, np.float32), at=np.array([0, 0.5, -1], np.float32),
        up=np.array([0, 1, 0], np.float32), fov=60.0, hither=0.01,
        res_x=res, res_y=res, aperture_ratio=0.0, focal_ratio=1.0))
    ys, xs = np.meshgrid(np.arange(res, dtype=np.float32),
                         np.arange(res, dtype=np.float32), indexing="ij")
    px = jnp.asarray(xs.reshape(-1) + 0.5)
    py = jnp.asarray(ys.reshape(-1) + 0.5)
    R = res * res
    tm = np.random.default_rng(seed).random(R, np.float32)
    jr = jcam.thin_lens_rays(cam, px, py, jnp.zeros((R, 2)), jnp.asarray(tm))
    return jr, Rays(t(jr.origin), t(jr.direction), t(jr.time))


@pytest.mark.parametrize("name,cfg", [
    ("tiny", dict(max_bounces=3)),
    ("tiny", dict(max_bounces=4, russian_roulette=True)),
    ("tiny", dict(max_bounces=2, reference_shadow_len1=True)),
    ("glsl", dict(max_bounces=4)),
])
def test_ray_color_presampled_matches_jax(name, cfg):
    if name == "tiny":
        jw, res, eye = tiny_world(), 8, (0.0, 2.0, 6.0)
    else:
        jw, res, eye = jgs.glsl_world(), 16, (-1.0, 0.0, 8.0)
    jr, r = camera_rays_np(res, seed=len(cfg), eye=eye)
    uni = np.random.default_rng(7).random(
        (cfg["max_bounces"], pt.N_UNIFORMS, res * res), np.float32)
    want = jpt.ray_color_presampled(jw, jpt.PTConfig(**cfg), jr,
                                    jnp.asarray(uni))
    got = pt.ray_color_presampled(jax_pt_scene_to_port(jw),
                                  pt.PTConfig(**cfg), r, t(uni))
    assert_pt_close(got.numpy(), want)
    assert float(got.std()) > 0.05  # a real image, not a constant


def test_render_progressive_cap_and_to_image():
    w = gs.glsl_world(device=CPU)
    cam = gs.glsl_camera(4, 4, device=CPU)
    cfg = pt.PTConfig(max_bounces=2, max_samples=3)
    g = torch.Generator().manual_seed(0)
    acc = pt.render_progressive(w, cam, cfg, g, n_frames=5)
    assert float(acc.count) == 3.0
    more = pt.render_progressive(w, cam, cfg, g, n_frames=5, acc=acc)
    assert float(more.count) == 3.0 and torch.equal(more.sum_linear,
                                                    acc.sum_linear)
    calls = []
    pt.render_progressive(w, cam, cfg, g, n_frames=5, acc=acc,
                          start_count=1.0,
                          frame_fn=lambda gen: calls.append(1) or
                          torch.zeros(4, 4, 3))
    assert len(calls) == 2

    s = np.random.default_rng(2).uniform(-0.5, 6.0, (5, 6, 3)).astype(
        np.float32)
    for count in (0.0, 4.0):
        got = pt.to_image(pt.Accumulator(t(s), torch.tensor(count)))
        want = jpt.to_image(jpt.Accumulator(jnp.asarray(s),
                                            jnp.float32(count)))
        close(got, want, 1e-6)


def test_checkpoint_layout_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    s = rng.random((6, 4, 3), np.float32)
    leaves, _ = jax.tree.flatten(jpt.Accumulator(jnp.asarray(s),
                                                 jnp.float32(7.0)))
    path = str(tmp_path / "jax_ckpt")
    np.savez(path + ".npz", *[np.asarray(x) for x in leaves])  # JAX's npz
    like = pt.make_accumulator(4, 6, device=CPU)
    acc = checkpoint.restore(path, like)
    np.testing.assert_array_equal(acc.sum_linear.numpy(), s)
    assert float(acc.count) == 7.0 and acc.count.shape == ()

    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, pt.make_accumulator(5, 6, device=CPU))
    np.savez(str(tmp_path / "three.npz"), s, np.float32(1), s)
    with pytest.raises(ValueError, match="3 arrays"):
        checkpoint.restore(str(tmp_path / "three"), like)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), like)

    # the port writes the same layout: arr_0, arr_1 in JAX's leaf order
    mine = str(tmp_path / "port")
    checkpoint.save(mine, acc)
    with np.load(mine + ".npz") as data:
        assert data.files == ["arr_0", "arr_1"]
        for got, want in zip((data["arr_0"], data["arr_1"]), leaves):
            np.testing.assert_array_equal(got, np.asarray(want))


def test_cli_pathtrace_checkpoint_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    png = str(tmp_path / "pt.png")
    base = ["pathtrace", "--device", "cpu", "--res", "8", "--frames", "2",
            "-o", png]
    assert cli.main(base + ["--checkpoint", ck]) == 0
    assert "2 spp accumulated" in capsys.readouterr().out
    assert cli.main(base + ["--resume", ck, "--checkpoint", ck,
                            "--pt-engine", "plain"]) == 0
    out = capsys.readouterr().out
    assert "resumed at 2 spp" in out and "4 spp accumulated" in out
    acc = checkpoint.restore(ck, pt.make_accumulator(8, 8, device=CPU))
    assert float(acc.count) == 4.0
    assert bool(torch.isfinite(acc.sum_linear).all())
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
