"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: scene recipes applied to either package's SceneDef, the hand-over
of a JAX Scene or PTScene to the port (core/convert.py), and the path
tracer's image rule."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu.models.whitted import render_tile

from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.convert import (
    pt_scene_from_arrays,
    scene_from_arrays,
)

_META = ("accel_type", "spp", "n_objects", "n_lights", "has_reflective",
         "has_transmissive", "has_skybox")


def jax_scene_to_port(jscene, device="cpu"):
    """A JAX Scene as the port's Scene, through NumPy, with its reference
    BVH or grid tables carried across."""
    arrays = {"bg_color": np.asarray(jscene.bg_color),
              "skybox": np.asarray(jscene.skybox)}
    meta = {k: getattr(jscene, k) for k in _META}
    for group in ("prims", "materials", "lights", "camera", "bvh", "grid"):
        obj = getattr(jscene, group)
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, int):
                meta[f.name] = v
            else:
                arrays[f"{group}.{f.name}"] = np.asarray(v)
    return scene_from_arrays(arrays, meta, torch.device(device))


def jax_pt_scene_to_port(jscene, device="cpu"):
    """A JAX PTScene as the port's PTScene, through NumPy."""
    arrays = {}
    for f in dataclasses.fields(jscene):
        v = getattr(jscene, f.name)
        if f.name == "materials":
            for g in dataclasses.fields(v):
                arrays[f"materials.{g.name}"] = np.asarray(getattr(v, g.name))
        else:
            arrays[f.name] = np.asarray(v)
    return pt_scene_from_arrays(arrays, torch.device(device))


def assert_pt_close(got, want, atol=2e-3):
    """The path tracer's image rule (tests/test_pt_megakernel.py:83-93): a
    reflect/refract decision that flips under f32 reordering changes a whole
    path, so at most 2% of pixels beyond atol and a mean absolute
    difference of at most 1e-4."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    assert (d.max(axis=-1) > atol).mean() <= 0.02, d.max()
    assert d.mean() <= 1e-4, d.mean()


def mixed_scene(sd, res=24):
    """tests/test_whitted_vs_oracle.py::mixed_scene on any SceneDef: spheres
    with reflection and refraction, a plane, a triangle, a box."""
    sd.set_camera(eye=[0.5, 1.5, 6], at=[0, 0.3, 0], up=[0, 1, 0], fov=40,
                  hither=0.01, res_x=res, res_y=res, aperture_ratio=0,
                  focal_ratio=1)
    diffuse = sd.add_material([0.7, 0.7, 0.2], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    mirror = sd.add_material([0.1, 0.1, 0.1], 0.2, [0.9, 0.9, 0.9], 0.8, 200,
                             0, 1)
    glass = sd.add_material([0.0, 0.0, 0.0], 0.0, [1, 1, 1], 0.1, 100, 1,
                            1.5)
    sd.add_plane_points([0, -0.5, 0], [1, -0.5, 0], [0, -0.5, -1], diffuse)
    sd.add_sphere([-1.2, 0.3, 0], 0.8, mirror)
    sd.add_sphere([1.0, 0.2, 1.0], 0.7, glass)
    sd.add_triangle([-0.5, -0.4, 2.0], [0.5, -0.4, 2.0], [0, 0.7, 1.8],
                    diffuse)
    sd.add_box([-0.4, -0.5, -1.5], [0.6, 0.5, -0.6], mirror)
    sd.add_light([4, 6, 4], [1, 1, 1])
    sd.bg_color = np.array([0.3, 0.5, 0.9], np.float32)
    return sd


def soup(sd, n_sph, n_tri, seed=2):
    """tests/test_accel.random_sphere_soup's shapes on either package's
    SceneDef: ``n_sph`` spheres and ``n_tri`` triangles in an 8-unit
    cube."""
    rng = np.random.default_rng(seed)
    sd.set_camera(eye=[0, 0, 12], at=[0, 0, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=16, res_y=16, aperture_ratio=0,
                  focal_ratio=1)
    m = sd.add_material([0.7, 0.7, 0.7], 1.0, [1, 1, 1], 0.3, 20, 0, 1)
    for _ in range(n_sph):
        sd.add_sphere(rng.uniform(-4, 4, 3), rng.uniform(0.2, 0.8), m)
    for _ in range(n_tri):
        base = rng.uniform(-4, 4, 3)
        sd.add_triangle(base, base + rng.uniform(-1, 1, 3),
                        base + rng.uniform(-1, 1, 3), m)
    sd.add_light([10, 10, 10], [1, 1, 1])
    return sd


def jax_render_image(jscene, cfg):
    """The JAX package's image of a deterministic config: its render_tile
    over the whole frame, run op by op (un-jitted) so that configs of one
    scene share compiled ops; render_image runs the same function under
    jit."""
    cam = jscene.camera
    ys, xs = np.meshgrid(np.arange(cam.res_y, dtype=np.float32),
                         np.arange(cam.res_x, dtype=np.float32),
                         indexing="ij")
    img = render_tile(jscene, jnp.asarray(xs.reshape(-1)),
                      jnp.asarray(ys.reshape(-1)), cfg, jax.random.PRNGKey(0))
    return np.asarray(img).reshape(cam.res_y, cam.res_x, 3)


def _uniform_np(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32))


def jax_stream_raw(ktrace, layout, R):
    """[n_rows, R] raw U[0,1) draws of the trace rows from the JAX key
    ``ktrace``, by the chain of ``_draw_stream`` (models/whitted_megakernel
    .py:724-738 of the JAX package: trace_rays -> _level_step ->
    direct_lighting): per level ``key, sub = split(key)``; ``lkey, klight =
    split(sub)``; per light under AA soft shadows ``klight, s2 =
    split(klight)`` and uniform(s2, [R·W, 2]); at a spawning level under
    fuzzy reflection ``lkey, kf = split(lkey)`` and the three uniforms of
    sample_unit_sphere(kf, [R·W]). Level draws are [R·W] with slot =
    ray·W + path."""
    raw = np.zeros((layout.n_rows, R), np.float32)
    shape = layout.shape
    key, w = ktrace, 1
    for lvl in range(shape.n_levels):
        key, sub = jax.random.split(key)
        lkey, klight = jax.random.split(sub)
        spawn = lvl < shape.n_levels - 1
        if layout.soft_jit:
            kk = klight
            for li in range(layout.n_lights):
                kk, s2 = jax.random.split(kk)
                r2 = _uniform_np(s2, (R * w, 2)).reshape(R, w, 2)
                for path in range(w):
                    rx, ry = layout.rowmap[("shadow", lvl, path, li)]
                    raw[rx], raw[ry] = r2[:, path, 0], r2[:, path, 1]
        if layout.has_fuzzy(lvl):
            lkey, kf = jax.random.split(lkey)
            ks = jax.random.split(kf, 3)
            u = [_uniform_np(k, (R * w,)).reshape(R, w) for k in ks]
            for path in range(w):
                for k, row in enumerate(layout.rowmap[("fuzzy", lvl, path)]):
                    raw[row] = u[k][:, path]
        if spawn:
            w *= shape.branch
    return raw


def jax_draws(key, layout, cfg, R):
    """The raw draws of the JAX package's ``render_tile(scene, px, py, cfg,
    key)`` for one tile of R pixels (models/whitted.py:502-536 and
    ops/camera.py:61-77 there), as the port's sample plan
    (models/samples.py): a list of ``Draws``, one per subpixel."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.samples import (
        Draws,
        subpixels,
    )

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    if cfg.anti_aliasing:
        keys = jax.random.split(key, max(cfg.spp, 1) ** 2)
        triples = [jax.random.split(k, 3) for k in keys]
    else:
        kcam, ktrace = jax.random.split(key, 3)[1:]
        triples = [(None, kcam, ktrace)]
    plan = []
    for ij, (kj, kcam, ktrace) in zip(subpixels(cfg), triples):
        jitter = _uniform_np(kj, (R, 2)) if kj is not None else None
        time = lens = None
        if cfg.motion_blur:
            kcam, sub = jax.random.split(kcam)
            time = _uniform_np(sub, (R,))
        if cfg.depth_of_field:
            kcam, sub = jax.random.split(kcam)
            k1, k2 = jax.random.split(sub)
            lens = np.stack([_uniform_np(k1, (R,)), _uniform_np(k2, (R,))],
                            axis=-1)
        rows = jax_stream_raw(ktrace, layout, R) if layout.n_rows else None
        plan.append(Draws(ij, t(jitter), t(time), t(lens), t(rows)))
    return plan


# XLA options for compiling a large one-off JAX reference (a Pallas kernel
# in interpret mode): the CPU backend at optimisation level 0 compiles
# mount_low's streamed kernel in about 18 s where the default takes about
# 23 s (paired runs on an 8-core x86 host). The program computes the
# same f32 operations; the port's tests hold it to their usual tolerances.
REFERENCE_COMPILE = {"xla_backend_optimization_level": 0}


def jax_reference(fn, *args):
    """``fn(*args)`` as one jitted JAX program compiled with
    REFERENCE_COMPILE, as a NumPy array."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options=REFERENCE_COMPILE)
    return np.asarray(compiled(*args))


def random_rays(n, seed, lo, hi):
    """(origins, unit directions) as float32 NumPy arrays from a seed."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run a test's PyTorch ops on one thread. The suite runs several
    worker processes on a few cores, and PyTorch's intra-op threads in each
    of them contend for the same cores: with them, the port's tests took
    twice the CPU time under six workers. Import it into a test module to
    apply it there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
