"""The port's ops (camera, intersection, shading) against the JAX package's
on the same seeded inputs.

Tolerances: camera rays atol 1e-6 (a handful of f32 ops); closest-hit ids
equal on all but 0.1% of rays (f32 rounding order can flip a winner at an
exact silhouette) and t within rtol 1e-5 where the ids agree; shading
atol 1e-5. The t reference is JAX's ``per_ray_t`` on its winners: for 64 or
more spheres JAX's closest hit takes its factored matrix-unit sphere form,
which loses about 8 bits to cancellation, and its renderer re-derives t in
the direct form, as the port does everywhere. The refraction inputs keep
away from the total-internal-reflection boundary (|cos_t²| > 1e-3 in
float64), where f32 rounding decides whether a ray refracts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
from u_4a_2s_p3d_raytracer_template2_tpu.core.types import Rays as JRays
from u_4a_2s_p3d_raytracer_template2_tpu.models import scenes as jscenes
from u_4a_2s_p3d_raytracer_template2_tpu.ops import camera as jcam
from u_4a_2s_p3d_raytracer_template2_tpu.ops import intersect as jint
from u_4a_2s_p3d_raytracer_template2_tpu.ops import shade as jshade
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import camera as pcam
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect as pint
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import shade as pshade
from torch_parity import (  # one_torch_thread: an autouse fixture
    jax_scene_to_port,
    mixed_scene,
    one_torch_thread,
    random_rays,
)

N = 4096

# (scene function, origin box): mount and mixed take the small-scene path,
# the 66-primitive sphere field the [R, chunk] typed path
SCENES = {
    "mount": (lambda: jscenes.mount_scene(res=16), -1.5, 1.5),
    "mixed": (lambda: mixed_scene(rt.SceneDef()), -2.0, 2.0),
    "sphere_field": (
        lambda: jscenes.sphere_field_scene(n_side=8, res=16, accel=0),
        -2.5, 2.5),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene_and_rays(name, seed):
    build, lo, hi = SCENES[name]
    jscene = rt.build_scene(build())
    o, d = random_rays(N, seed, lo, hi)
    return jscene, jax_scene_to_port(jscene), o, d


def test_pinhole_rays_match_jax():
    jscene = rt.build_scene(jscenes.mount_scene(res=64))
    pscene = jax_scene_to_port(jscene)
    rng = np.random.default_rng(1)
    px = rng.uniform(0, 64, N).astype(np.float32)
    py = rng.uniform(0, 64, N).astype(np.float32)
    want = jcam.pinhole_rays(jscene.camera, jnp.asarray(px), jnp.asarray(py))
    got = pcam.pinhole_rays(pscene.camera, _t(px), _t(py))
    np.testing.assert_allclose(got.direction.numpy(),
                               np.asarray(want.direction), atol=1e-6)
    np.testing.assert_allclose(got.origin.numpy(), np.asarray(want.origin),
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_hit_and_normals_match_jax(name):
    jscene, pscene, o, d = _scene_and_rays(name, seed=2)
    t_j, id_j = jax.jit(jint.closest_hit_brute)(
        jscene.prims, JRays.make(o, d))
    t_j, id_j = np.asarray(t_j), np.asarray(id_j)
    t_p, id_p = pint.closest_hit_brute(pscene.prims, Rays.make(_t(o), _t(d)))
    t_p, id_p = t_p.numpy(), id_p.numpy()
    agree = id_j == id_p
    assert agree.mean() >= 0.999
    hit = agree & (id_p >= 0)
    assert hit.sum() > N // 20  # the rays do hit the scene

    # t against JAX's shade-time re-intersection of each winner (module doc)
    present = (True, True, True, True)
    jp, jtype, _ = jint.gather_prims(jscene.prims, jnp.asarray(id_j))
    pp, ptype, _ = pint.gather_prims(pscene.prims, torch.from_numpy(id_p))
    np.testing.assert_array_equal(ptype.numpy()[agree],
                                  np.asarray(jtype)[agree])
    tj = np.asarray(jint.per_ray_t(jp, jtype, o, d, present))
    tp = pint.per_ray_t(pp, ptype, _t(o), _t(d), present).numpy()
    np.testing.assert_allclose(t_p[hit], tj[hit], rtol=1e-5)
    np.testing.assert_allclose(tp[hit], tj[hit], rtol=1e-5)
    point = o + d * np.where(hit, tj, 1.0)[:, None]
    nj = np.asarray(jint.per_ray_normal(jp, jtype, point, o, d, present))
    npt = pint.per_ray_normal(pp, ptype, _t(point), _t(o), _t(d),
                              present).numpy()
    np.testing.assert_allclose(npt[hit], nj[hit], atol=1e-5)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_any_hit_matches_jax(name):
    jscene, pscene, o, d = _scene_and_rays(name, seed=3)
    # unnormalized shadow-style directions: max_t 1 bounds them at length 1
    scale = np.random.default_rng(4).uniform(0.2, 3.0, (N, 1))
    d = (d * scale).astype(np.float32)
    for max_t in (1.0, 1e30):
        want = np.asarray(jax.jit(jint.any_hit_brute, static_argnums=2)(
            jscene.prims, JRays.make(o, d), max_t))
        got = pint.any_hit_brute(pscene.prims, Rays.make(_t(o), _t(d)),
                                 max_t).numpy()
        assert 0 < want.sum() < N
        assert (got == want).mean() >= 0.999


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _refract_inputs(seed):
    rng = np.random.default_rng(seed)
    d = _unit(rng, 2 * N)
    n = _unit(rng, 2 * N)
    inside = (d * n).sum(-1) > 0
    nf = np.where(inside[:, None], -n, n).astype(np.float32)
    ior_1 = rng.choice(np.float32([1.0, 1.5, 1.6]), 2 * N)
    mat_ior = rng.choice(np.float32([0.0, 1.3, 1.6]), 2 * N)
    # cos_t² in float64; keep N rows away from the TIR boundary (module doc)
    d64, nf64 = d.astype(np.float64), nf.astype(np.float64)
    ndv = -(nf64 * d64).sum(-1)
    vt = nf64 * ndv[:, None] + d64
    eta = np.where(inside, ior_1, ior_1 / np.where(mat_ior > 0, mat_ior, 1))
    cos_t2 = 1.0 - eta ** 2 * (vt * vt).sum(-1)
    keep = np.nonzero(np.abs(cos_t2) > 1e-3)[0][:N]
    return d[keep], nf[keep], inside[keep], ior_1[keep], mat_ior[keep]


@pytest.mark.parametrize("mode", ["reference", "physical"])
def test_refract_matches_jax(mode):
    d, nf, inside, ior_1, mat_ior = _refract_inputs(5)
    want = jshade.refract(d, nf, inside, ior_1, mat_ior, mode)
    got = pshade.refract(_t(d), _t(nf), _t(inside), _t(ior_1), _t(mat_ior),
                         mode)
    can = np.asarray(want.can_refract)
    np.testing.assert_array_equal(got.can_refract.numpy(), can)
    assert 0 < can.sum() < N  # both refraction and TIR lanes
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy()[can], np.asarray(b)[can],
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["schlick", "reference_schlick",
                                  "reference_exact"])
def test_fresnel_kr_matches_jax(mode):
    d, nf, inside, ior_1, mat_ior = _refract_inputs(6)
    rng = np.random.default_rng(7)
    transmit = rng.choice(np.float32([0.0, 1.0]), N)
    ks = rng.uniform(0, 1, N).astype(np.float32)
    ro_j = jshade.refract(d, nf, inside, ior_1, mat_ior, "reference")
    ro_p = pshade.refract(_t(d), _t(nf), _t(inside), _t(ior_1),
                          _t(mat_ior), "reference")
    want = np.asarray(jshade.fresnel_kr(ro_j, ior_1, transmit, ks, mode))
    got = pshade.fresnel_kr(ro_p, _t(ior_1), _t(transmit), _t(ks),
                            mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_blinn_phong_matches_jax():
    rng = np.random.default_rng(8)
    f = np.float32
    L = rng.normal(size=(N, 3)).astype(f) * 3
    lit = rng.uniform(size=N) < 0.8
    lcol = rng.uniform(0, 1, (1, 3)).astype(f)
    mat = [rng.uniform(0, 1, (N, 3)).astype(f), rng.uniform(0, 1, N).astype(f),
           rng.uniform(0, 1, (N, 3)).astype(f), rng.uniform(0, 1, N).astype(f),
           np.where(rng.uniform(size=N) < 0.1, 0.0,
                    rng.uniform(1, 200, N)).astype(f),
           np.zeros(N, f), np.ones(N, f)]
    d = _unit(rng, N)
    n = _unit(rng, N)
    want = jshade.blinn_phong(L, lit, lcol, jshade.MatView(*mat), d, n)
    got = pshade.blinn_phong(_t(L), _t(lit), _t(lcol),
                             pshade.MatView(*[_t(m) for m in mat]), _t(d),
                             _t(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
