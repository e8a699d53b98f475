"""The BVH walk's plain version (accel/packets.py) against brute force.

The walk runs the brute-force formulas with brute force's tie rule, so
against the port's own brute force (ops/intersect.py) its answers are equal,
exactly: closest t and ids, occlusion at max_t 1 and unbounded, with and
without ``dead`` lanes, and the fused multi-light query against one query
per light. Against the JAX package's brute force, on the same seeded rays:
ids equal and occlusion equal; t within 1e-5 against JAX's t re-derived on
the winner as its renderer does (at 64 or more spheres JAX's closest hit
takes its factored matrix-unit sphere form, which loses about 8 bits,
tests/test_torch_ops.py), except at grazing sphere hits and on spheres of
radius 1000, where cancellation moves t by a few 1e-5 in both packages.
Against JAX's packet kernels in Pallas interpret mode, JAX's own tolerance
(tests/test_packets.py).
"""
import jax
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.core.types import Rays as JRays
from u_4a_2s_p3d_raytracer_template2_tpu.models import scenes as jscenes
from u_4a_2s_p3d_raytracer_template2_tpu.ops import intersect as jint
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    pixel_grid,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import pinhole_rays
from torch_parity import (  # one_torch_thread: an autouse fixture
    mixed_scene,
    one_torch_thread,
    random_rays,
)

CPU = torch.device("cpu")
N = 2048

# (SceneDef of either package, origin box of the incoherent rays)
SCENES = {
    "field": (lambda m: m.sphere_field_scene(n_side=16, res=32), -5.0, 5.0),
    "mixed": (lambda m: mixed_scene(m.SceneDef(), res=32), -2.5, 2.5),
    "random": (lambda m: m.random_scene(32, 32), -6.0, 6.0),
}


class _Port:
    SceneDef = pt.SceneDef
    sphere_field_scene = staticmethod(scenes.sphere_field_scene)
    random_scene = staticmethod(scenes.random_scene)


class _Jax:
    SceneDef = rt.SceneDef
    sphere_field_scene = staticmethod(jscenes.sphere_field_scene)
    random_scene = staticmethod(jscenes.random_scene)


def _port_scene(name):
    sd = SCENES[name][0](_Port)
    sd.accel_type = C.ACCEL_BVH
    return pt.build_scene(sd, device=CPU)


def _rays(scene, name, kind, seed=1):
    """Coherent: the camera's primary rays at 32x32; incoherent: random
    origins and unit directions."""
    if kind == "coherent":
        px, py = pixel_grid(32, 32, CPU)
        r = pinhole_rays(scene.camera, px + 0.5, py + 0.5)
        return r.origin, r.direction
    _, lo, hi = SCENES[name]
    o, d = random_rays(N, seed, lo, hi)
    return torch.from_numpy(o), torch.from_numpy(d)


def _segments(name, o, seed):
    """Two sets of unnormalized shadow-style segments from the origins to
    random points of the scene's box."""
    _, lo, hi = SCENES[name]
    rng = np.random.default_rng(seed)
    ends = rng.uniform(lo, hi, (2,) + tuple(o.shape)).astype(np.float32)
    return [torch.from_numpy(e) - o for e in ends]


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_equals_port_brute_force(name, kind):
    scene = _port_scene(name)
    o, d = _rays(scene, name, kind)
    t, obj = packets.packet_closest_hit(scene.packets, Rays.make(o, d))
    t_b, obj_b = intersect.closest_hit_brute(scene.prims, Rays.make(o, d))
    assert torch.equal(obj, obj_b) and torch.equal(t, t_b)
    assert 0 < int((obj >= 0).sum()) < o.shape[0]

    segs = _segments(name, o, 2)
    dead = [torch.from_numpy(np.random.default_rng(3 + i).uniform(
        size=o.shape[0]) < 0.3) for i in range(2)]
    for max_t in (1.0, C.BIG):
        for i, s in enumerate(segs):
            want = intersect.any_hit_brute(scene.prims, Rays.make(o, s),
                                           max_t)
            got = packets.packet_any_hit(scene.packets, Rays.make(o, s),
                                         max_t)
            assert torch.equal(got, want)
            assert 0 < int(want.sum()) < o.shape[0]
            got = packets.packet_any_hit(scene.packets, Rays.make(o, s),
                                         max_t, dead[i])
            assert torch.equal(got, want | dead[i])
        multi = packets.packet_any_hit_multi(scene.packets, o, segs, max_t,
                                             dead)
        assert multi.shape == (2, o.shape[0])
        for i, s in enumerate(segs):
            assert torch.equal(multi[i], packets.packet_any_hit(
                scene.packets, Rays.make(o, s), max_t, dead[i]))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_matches_jax_brute_force(name):
    scene = _port_scene(name)
    jscene = rt.build_scene(SCENES[name][0](_Jax), accel=C.ACCEL_NONE)
    o, d = _rays(scene, name, "incoherent", seed=5)
    t, obj = packets.packet_closest_hit(scene.packets, Rays.make(o, d))
    t, obj = t.numpy(), obj.numpy()
    t_j, obj_j = jax.jit(jint.closest_hit_brute)(
        jscene.prims, JRays.make(o.numpy(), d.numpy()))
    np.testing.assert_array_equal(obj, np.asarray(obj_j))
    hit = obj >= 0
    assert hit.sum() > N // 20
    # JAX's t as its renderer re-derives it on the winner (module doc)
    jp, jtype, _ = jint.gather_prims(jscene.prims, obj_j)
    t_j = np.asarray(jint.per_ray_t(jp, jtype, o.numpy(), d.numpy(),
                                    (True, True, True, True)))
    # grazing sphere hits: |n·d| < 0.25 at the port's hit point
    params = scene.prims.params[np.maximum(obj, 0)].numpy()
    p = o.numpy() + d.numpy() * np.where(hit, t, 0.0)[:, None]
    n = p - params[:, :3]
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    # and hits on random_scene's ground sphere (radius 1000), where
    # |o-c|^2 - r^2 cancels about six digits
    sphere = scene.prims.ptype[np.maximum(obj, 0)].numpy() == C.SPHERE
    coarse = sphere & ((np.abs((n * d.numpy()).sum(1)) < 0.25)
                       | (params[:, 3] > 100.0))
    ok = hit & ~coarse
    np.testing.assert_allclose(t[ok], t_j[ok], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t[hit], t_j[hit], atol=1e-4, rtol=1e-4)

    segs = _segments(name, o, 6)
    for max_t in (1.0, C.BIG):
        for s in segs:
            got = packets.packet_any_hit(scene.packets, Rays.make(o, s),
                                         max_t).numpy()
            want = np.asarray(jax.jit(jint.any_hit_brute, static_argnums=2)(
                jscene.prims, JRays.make(o.numpy(), s.numpy()), max_t))
            assert 0 < want.sum() < N
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("query", ["closest", "any"])
def test_walk_matches_jax_packet_kernels_interpret(query):
    """JAX's K5c (flat closest) and K5b (stack any-hit) in interpret mode on
    a 196-sphere field (MIN_TREE is met), 256 rays, at the tolerance of
    tests/test_packets.py."""
    from u_4a_2s_p3d_raytracer_template2_tpu.accel.packets import (
        build_packets,
        packet_any_hit,
        packet_closest_hit,
    )

    jscene = rt.build_scene(jscenes.sphere_field_scene(n_side=14, res=8),
                            accel=C.ACCEL_NONE)
    jpt = build_packets(np.asarray(jscene.prims.params),
                        np.asarray(jscene.prims.ptype))
    assert jpt is not None and jpt.has_sph
    scene = pt.build_scene(scenes.sphere_field_scene(n_side=14, res=8),
                           device=CPU)
    o, d = random_rays(256, 9, -4.0, 4.0)
    if query == "closest":
        t_j, obj_j = packet_closest_hit(jpt, jscene.prims, JRays.make(o, d),
                                        interpret=True)
        t, obj = packets.packet_closest_hit(
            scene.packets, Rays.make(torch.from_numpy(o), torch.from_numpy(d)))
        np.testing.assert_allclose(np.minimum(t.numpy(), 1e30),
                                   np.minimum(np.asarray(t_j), 1e30),
                                   rtol=1e-4, atol=1e-4)
        assert (obj.numpy() == np.asarray(obj_j)).mean() > 0.995
        assert (obj.numpy() >= 0).any()
    else:
        seg = (np.random.default_rng(10).uniform(-4, 4, (256, 3))
               .astype(np.float32) - o)
        occ_j = np.asarray(packet_any_hit(jpt, jscene.prims,
                                          JRays.make(o, seg), 1.0,
                                          interpret=True))
        occ = packets.packet_any_hit(
            scene.packets, Rays.make(torch.from_numpy(o),
                                     torch.from_numpy(seg)), 1.0).numpy()
        assert 0 < occ_j.sum() < 256
        assert (occ == occ_j).mean() > 0.995


def test_walk_takes_empty_batches():
    scene = _port_scene("mixed")
    o = torch.zeros(0, 3)
    t, obj = packets.packet_closest_hit(scene.packets, Rays.make(o, o))
    assert t.shape == obj.shape == (0,)
    assert packets.packet_any_hit(scene.packets, Rays.make(o, o),
                                  1.0).shape == (0,)


def test_chip_smoke_records_the_main_paths_queries():
    """chip_smoke.py's BVH cases on the CPU: one sweep level's shadow
    queries (one per light, with their dead masks) and level-1 rays, and
    the readings that judge a kernel against its plain version."""
    import chip_smoke

    scene = _port_scene("field")
    o, d = chip_smoke.camera_rays(scene)
    R = o.shape[0]
    queries, (kids, active, ior) = chip_smoke.main_path_queries(
        scene, Rays.make(o, d), torch.ones(R, dtype=torch.bool),
        torch.ones(R), pt.RenderConfig())
    assert packets.packet_any_hit.__name__ == "packet_any_hit"  # restored
    assert len(queries) == scene.n_lights == 2
    for qo, qd, max_t, dead in queries:
        assert qo.shape == qd.shape == (R, 3) and max_t == 1.0
        assert dead.dtype == torch.bool and 0 < int(dead.sum()) < R
    assert kids.origin.shape == (2 * R, 3) and active.shape == ior.shape
    assert 0 < int(active.sum()) < 2 * R

    want = packets.closest_hit_plain(scene.packets, o, d)
    assert not chip_smoke.bvh_rejects(
        chip_smoke.bvh_agreement("closest", want, want))
    t, obj = want[0].clone(), want[1].clone()
    obj[0] = 7 if obj[0] != 7 else 8
    reading = chip_smoke.bvh_agreement("closest", (t, obj), want)
    assert chip_smoke.bvh_rejects(reading) == ["ids"]
    hit = int(torch.nonzero(want[1] >= 0)[0])
    t[hit] *= 1.0 + 1e-4
    reading = chip_smoke.bvh_agreement("closest", (t, want[1]), want)
    assert chip_smoke.bvh_rejects(reading) == ["t_rel"]
    occ = packets.any_hit_plain(scene.packets, *queries[0])
    assert chip_smoke.bvh_rejects(
        chip_smoke.bvh_agreement("any", ~occ, occ)) == ["occ"]
