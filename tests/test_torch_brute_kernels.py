"""The brute-force kernels' plain version (ops/intersect.closest_hit_plain,
any_hit_plain) against the JAX package's Pallas kernels K4a-K4e in
interpret mode, and the packed tables the CUDA kernels read.

The kernels (csrc/brute_intersect.cu) run only on a card: chip_smoke.py
and tests/test_torch_cuda.py hold them against this plain version there.
Against JAX, on the same seeded soups and rays (about 1,024 rays, at most
1,280 primitive rows a call): ids equal on >= 99.5% of rays, t within 1e-5
(rtol and atol) on >= 99.5%, occlusion equal on >= 99.5% -- JAX's own rule
between its Pallas kernels and its XLA forms
(tests/test_pallas_kernels.py:14-22,50-51). The gap is JAX's expanded
sphere quadratic and Baldwin-Weber triangles against the port's direct
(o-c) form and Moller-Trumbore.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
from u_4a_2s_p3d_raytracer_template2_tpu.ops import pallas_intersect as pk
from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect
from torch_parity import (  # one_torch_thread: an autouse fixture
    jax_scene_to_port,
    one_torch_thread,
    random_rays,
    soup,
)

N_RAYS = 1024
SHARE = 0.995


@functools.cache
def _scenes(n_sph, n_tri):
    """(JAX scene, the port's scene on the CPU) of one soup, brute force."""
    jscene = rt.build_scene(soup(rt.SceneDef(), n_sph, n_tri),
                            accel=C.ACCEL_NONE)
    return jscene, jax_scene_to_port(jscene)


def _rays(seed):
    o, d = random_rays(N_RAYS, seed, -8.0, 8.0)
    return o, d, Rays.make(torch.from_numpy(o), torch.from_numpy(d))


def _shares_closest(port, jax_out):
    """(share of equal ids, share of t within 1e-5), printed."""
    t_p, id_p = (x.numpy() for x in port)
    t_j, id_j = (np.asarray(x) for x in jax_out)
    ids = float((id_p == id_j).mean())
    close = float(np.isclose(np.minimum(t_p, C.BIG), np.minimum(t_j, C.BIG),
                             rtol=1e-5, atol=1e-5).mean())
    print(f"ids equal on {ids * 100:.2f}%, t within 1e-5 on "
          f"{close * 100:.2f}% of {len(id_p)} rays; "
          f"{int((id_p >= 0).sum())} hits")
    return ids, close


def test_sphere_closest_matches_k4a():
    jscene, pscene = _scenes(1100, 0)
    o, d, rays = _rays(3)
    p = jscene.prims
    ids, close = _shares_closest(
        intersect.closest_hit_plain(pscene.prims, rays),
        pk.sphere_closest(p.sph_p[:, 0:3], p.sph_k, p.sph_ids,
                          jnp.asarray(o), jnp.asarray(d), interpret=True))
    assert ids >= SHARE and close >= SHARE


def test_triangle_closest_matches_k4e():
    jscene, pscene = _scenes(0, 1100)
    o, d, rays = _rays(4)
    p = jscene.prims
    ids, close = _shares_closest(
        intersect.closest_hit_plain(pscene.prims, rays),
        pk.triangle_closest(p.tri_mo, p.tri_md, p.tri_ids, jnp.asarray(o),
                            jnp.asarray(d), interpret=True))
    assert ids >= SHARE and close >= SHARE


def test_both_tables_closest_matches_k4b():
    """Triangles before spheres on exact cross-type ties, as K4b's
    concatenated table orders them."""
    jscene, pscene = _scenes(1024, 256)
    o, d, rays = _rays(5)
    p = jscene.prims
    ids, close = _shares_closest(
        intersect.closest_hit_plain(pscene.prims, rays),
        pk.small_scene_closest(p.tri_mo, p.tri_ids, p.sph_p[:, 0:3],
                               p.sph_k, p.sph_ids, jnp.asarray(o),
                               jnp.asarray(d), interpret=True))
    assert ids >= SHARE and close >= SHARE


@pytest.mark.parametrize("max_t", [0.5, 2.0, 10.0, C.BIG])
def test_any_hit_matches_k4c_and_k4d(max_t):
    """K4c over a sphere soup, K4d over a triangle soup, at max_t 0.5, 2,
    10 and unbounded."""
    o, d, rays = _rays(6)
    for n_sph, n_tri, jax_occ in (
            (1100, 0, lambda p: pk.sphere_any_hit(
                p.sph_p[:, 0:3], p.sph_k, jnp.asarray(o), jnp.asarray(d),
                max_t, interpret=True)),
            (0, 1100, lambda p: pk.triangle_any_hit(
                p.tri_mo, jnp.asarray(o), jnp.asarray(d), max_t,
                interpret=True))):
        jscene, pscene = _scenes(n_sph, n_tri)
        want = np.asarray(jax_occ(jscene.prims))
        got = intersect.any_hit_plain(pscene.prims, rays, max_t).numpy()
        same = float((got == want).mean())
        print(f"{n_sph} spheres, {n_tri} triangles, max_t {max_t:g}: "
              f"occlusion equal on {same * 100:.2f}% of {N_RAYS} rays, "
              f"{int(want.sum())} occluded")
        assert same >= SHARE


def _tables_closest(tb, o, d):
    """Closest hit over packed tables with the kernels' tie rule written
    out: the smallest t, then triangle before sphere, then the lowest id,
    whatever the row order."""
    o_cols = tuple(o[:, k:k + 1] for k in range(3))
    d_cols = tuple(d[:, k:k + 1] for k in range(3))
    t = torch.cat([
        intersect._triangle_t_one([tb.tri[None, :, k] for k in range(9)],
                                  o_cols, d_cols),
        intersect._sphere_t_one([tb.sph[None, :, k] for k in range(4)],
                                o_cols, d_cols)], dim=1)
    rank = torch.cat([torch.zeros(tb.n_tri, dtype=torch.int64),
                      torch.ones(tb.n_sph, dtype=torch.int64)])
    ids = torch.cat([tb.tri[:, 9].contiguous().view(torch.int32),
                     tb.sph_ids]).to(torch.int64)
    key = torch.where(t == t.min(dim=1, keepdim=True).values,
                      rank * 2 ** 32 + ids, 2 ** 40)
    best = key.min(dim=1).values
    t_best = t.min(dim=1).values
    obj = torch.where(t_best >= C.BIG, -1, best % 2 ** 32).to(torch.int32)
    return t_best, obj


def _twinned_prims():
    """Every sphere and triangle of a soup added twice."""
    sd = soup(rt.SceneDef(), 150, 150)
    sd.objects = [o for o in sd.objects for _ in range(2)]
    return jax_scene_to_port(rt.build_scene(sd, accel=C.ACCEL_NONE)).prims


def test_packed_tables_hold_the_plain_versions_answers():
    """The tables the kernels read (BruteTables: spheres (c, r) with their
    ids beside them, triangles (v0, e1, e2, id bits)), read with the
    kernels' tie rule, give the plain version's hits exactly, also with the
    rows shuffled and every primitive twinned, where only the ids decide."""
    prims = _twinned_prims()
    tb = intersect.brute_tables(prims)
    assert (tb.n_sph, tb.n_tri) == (300, 300)
    assert tb.sph.shape == (300, 4) and tb.tri.shape == (300, 12)
    assert tb.sph_ids.dtype == torch.int32 and bool((tb.sph_ids >= 0).all())
    # aim at primitives so that twins tie
    rng = np.random.default_rng(7)
    p = prims.params[:600].numpy()
    aims = np.concatenate([p[prims.ptype[:600].numpy() == C.SPHERE, :3],
                           p[prims.ptype[:600].numpy() == C.TRIANGLE, :3]])
    o = rng.uniform(-8, 8, aims.shape).astype(np.float32)
    d = aims - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    want = intersect.closest_hit_plain(prims, Rays.make(o, d))
    assert int((want[1] >= 0).sum()) > 500
    g = torch.Generator().manual_seed(0)
    ps, pt = torch.randperm(300, generator=g), torch.randperm(300, generator=g)
    for table in (tb, intersect.BruteTables(tb.sph[ps], tb.sph_ids[ps],
                                            tb.tri[pt], 300, 300)):
        t, obj = _tables_closest(table, o, d)
        assert torch.equal(obj, want[1]) and torch.equal(t, want[0])


def test_every_scene_carries_its_packed_tables():
    """A scene built by the port (core/build.py) or converted from the JAX
    package's (core/convert.py) carries the kernels' tables of its own
    primitives (Scene.brute), packed once."""
    import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt

    _, converted = _scenes(1024, 256)
    built = pt.build_scene(soup(pt.SceneDef(), 1024, 256),
                           accel=C.ACCEL_NONE, device="cpu")
    for scene in (converted, built):
        want = intersect.brute_tables(scene.prims)
        got = scene.brute
        assert (got.n_sph, got.n_tri) == (1024, 256)
        for name in ("sph", "sph_ids", "tri"):
            assert torch.equal(getattr(got, name), getattr(want, name))


def test_the_wrappers_refuse_cpu_tensors():
    """No fallback: CPU tensors reach the kernels' wrappers only as a
    ValueError, before any build."""
    _, pscene = _scenes(1100, 0)
    tb = intersect.brute_tables(pscene.prims)
    o, d, _ = _rays(8)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.brute_closest(tb, o, d)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.brute_any(tb, o, d, 1.0)
