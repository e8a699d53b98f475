"""Dead slots in the brute-force closest hit and any hit, and in the BVH
walk's closest hit, and the count of the brute-force kernels' work that
their bound reads.

With a ``dead`` mask, ops/intersect's plain version and dispatch, and the
walk's (accel/packets.py), trace only the live slots: those read the
unmasked answer bit for bit, the dead ones (BIG, -1), or occluded. ``intersect.brute_stages`` counts each test by
where it ended, from the plain version's formulas, on scenes small enough
to count by hand. All on the CPU; the kernels (csrc/brute_intersect.cu)
are held to the same rules on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect
from torch_parity import (  # one_torch_thread: an autouse fixture
    one_torch_thread,
    random_rays,
    soup,
)

CPU = torch.device("cpu")
N_RAYS = 512


def _scene(n_sph, n_tri, accel=C.ACCEL_NONE):
    """A seeded soup under ``accel`` with a plane under it and a box."""
    sd = soup(pt.SceneDef(), n_sph, n_tri)
    m = sd.add_material([0.5, 0.5, 0.5], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    sd.add_plane_points([0, -5, 0], [1, -5, 0], [0, -5, -1], m)
    sd.add_box([-5, -5, -5], [-4, -4, -4], m)
    return pt.build_scene(sd, device=CPU, accel=accel)


def _rays():
    o, d = random_rays(N_RAYS, 11, -6.0, 6.0)
    return Rays.make(torch.from_numpy(o), torch.from_numpy(d))


def _dead(kind):
    if kind == "none dead":
        return torch.zeros(N_RAYS, dtype=torch.bool)
    if kind == "all dead":
        return torch.ones(N_RAYS, dtype=torch.bool)
    g = torch.Generator().manual_seed(3)
    return torch.rand(N_RAYS, generator=g) < 0.35


MASKS = ("none dead", "all dead", "a third dead")
# the plain version; the dispatch above SMALL_UNROLL_MAX primitives (the
# plain version on the CPU, planes and the box folded in); the dispatch's
# one-test-per-primitive path at or below it; the BVH walk's dispatch (its
# plain version on the CPU) over the same soup's tree, the plane beside it
PATHS = {
    "walk": (lambda: _scene(60, 60, C.ACCEL_BVH),
             lambda s, r, dead=None: packets.packet_closest_hit(
                 s.packets, r, dead)),
    "plain": (lambda: _scene(60, 60),
              lambda s, r, dead=None: intersect.closest_hit_plain(
                  s.prims, r, dead)),
    "dispatch": (lambda: _scene(60, 60),
                 lambda s, r, dead=None: intersect.closest_hit_brute(
                     s.prims, r, s.brute, dead)),
    "small": (lambda: _scene(20, 20),
              lambda s, r, dead=None: intersect.closest_hit_brute(
                  s.prims, r, s.brute, dead)),
}


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("path", sorted(PATHS))
def test_dead_slots_read_no_hit_and_live_slots_the_unmasked_answer(path,
                                                                   mask):
    make, closest = PATHS[path]
    scene, rays, dead = make(), _rays(), _dead(mask)
    assert (intersect._small_total(scene.prims)
            <= intersect.SMALL_UNROLL_MAX) == (path == "small")
    want_t, want_id = closest(scene, rays)
    assert int((want_id >= 0).sum()) > N_RAYS // 8
    if path == "walk":  # the dispatch is the plain walk on the CPU
        o, d = rays.origin, rays.direction
        for got, want in zip(packets.closest_hit_plain(scene.packets, o, d,
                                                       dead),
                             closest(scene, rays, dead)):
            assert torch.equal(got, want)
    t, obj = closest(scene, rays, dead)
    live = ~dead
    assert torch.equal(t[live], want_t[live])
    assert torch.equal(obj[live], want_id[live])
    assert bool((t[dead] == C.BIG).all()) and bool((obj[dead] == -1).all())


@pytest.mark.parametrize("mask", MASKS)
def test_any_hit_plain_traces_only_live_slots(mask):
    scene, rays, dead = _scene(60, 60), _rays(), _dead(mask)
    want = intersect.any_hit_plain(scene.prims, rays, 2.0)
    assert 0 < int(want.sum()) < N_RAYS
    got = intersect.any_hit_plain(scene.prims, rays, 2.0, dead)
    assert torch.equal(got[~dead], want[~dead]) and bool(got[dead].all())


def _stage_prims():
    """Four triangles and five spheres that a ray from (0, 0, -10) along +z
    meets as counted by hand: triangle B is parallel to it (its test ends
    at the det gate), C lies to its side (u < 0), A is hit at t = 15, D
    fails the v gate (v = -1); the unit sphere at the origin is hit at
    t = 9 (its roots), the four at (+-10, +-10, 0) end at the
    discriminant. Table order: triangles B, C, A, D; spheres (10, 10),
    (-10, 10), the origin, (10, -10), (-10, -10)."""
    sd = pt.SceneDef()
    sd.accel_type = C.ACCEL_NONE
    sd.set_camera(eye=[0, 0, -10], at=[0, 0, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=4, res_y=4, aperture_ratio=0,
                  focal_ratio=1)
    m = sd.add_material([0.7, 0.7, 0.7], 1.0, [1, 1, 1], 0.1, 20, 0, 1)
    for v0, e1, e2 in (([5, 0, 0], [0, 0, 1], [0, 1, 0]),    # B
                       ([2, 2, 5], [2, 0, 0], [0, 2, 0]),    # C
                       ([-1, -1, 5], [4, 0, 0], [0, 4, 0]),  # A
                       ([-1, 2, 5], [2, 0, 0], [0, 2, 0])):  # D
        v0, e1, e2 = (np.array(x, np.float32) for x in (v0, e1, e2))
        sd.add_triangle(v0, v0 + e1, v0 + e2, m)
    for c in ([10, 10, 0], [-10, 10, 0], [0, 0, 0], [10, -10, 0],
              [-10, -10, 0]):
        sd.add_sphere(c, 1.0, m)
    sd.add_light([0, 10, -10], [1, 1, 1])
    return pt.build_scene(sd, device=CPU).prims


def _stage_rays():
    """The counted ray, and a second ray that a dead mask drops."""
    return Rays.make(torch.tensor([[0.0, 0.0, -10.0], [0.0, 0.0, -10.0]]),
                     torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]))


def test_brute_stages_count_a_closest_hit_by_hand():
    """A closest hit tests every row: one triangle test ends at each gate
    and one with its t; of the five spheres, the ray goes through one."""
    prims, rays = _stage_prims(), _stage_rays()
    dead = torch.tensor([False, True])
    t, obj = intersect.closest_hit_plain(prims, rays, dead)
    assert float(t[0]) == 9.0 and int(obj[1]) == -1
    assert intersect.brute_stages(prims, rays, dead=dead).tolist() == [
        1, 1, 1, 1, 4, 1]
    assert len(intersect.BRUTE_STAGES) == 6


@pytest.mark.parametrize("max_t, want", [
    (C.BIG, [1, 1, 0, 1, 0, 0]),  # stops at A, the third triangle
    (12.0, [1, 1, 1, 1, 2, 1]),   # A at 15 is past the end; the sphere at 9
    (3.0, [1, 1, 1, 1, 4, 1]),    # nothing before 3: every row
])
def test_brute_stages_stop_an_any_hit_at_its_first_occluder(max_t, want):
    """An any hit tests the rows in table order, triangles first, up to and
    including its first occluder (t < max_t)."""
    prims, rays = _stage_prims(), _stage_rays()
    dead = torch.tensor([False, True])
    occ = intersect.any_hit_plain(prims, rays, max_t, dead)
    assert bool(occ[0]) == (max_t > 9.0) and bool(occ[1])
    assert intersect.brute_stages(prims, rays, max_t, dead).tolist() == want
