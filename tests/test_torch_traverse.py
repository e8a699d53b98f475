"""The port's reference accelerators (accel/bvh.py, accel/grid.py,
native/, accel/traverse.py) against the JAX package's.

The builders give the JAX builders' arrays, array for array, natively and
in NumPy; the port's native and NumPy builds agree as JAX's own test
requires (tests/test_accel.py:90-125). The per-ray walk and DDA run on the
JAX scene's own tables (carried across by core/convert.py) and give the JAX
traversals' ids exactly, t within 1e-5, the same occlusion, and
``reference_grid_shadow_initfail``'s quirk; against the port's brute force,
t within 1e-4 and ids on 99.5% of rays (ties), as tests/test_accel.py
holds JAX's. Renders under ``accel_impl="perray"`` equal the walk's.
"""
import jax
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.accel import bvh as jbvh
from u_4a_2s_p3d_raytracer_template2_tpu.accel import grid as jgrid
from u_4a_2s_p3d_raytracer_template2_tpu.accel import traverse as jtrav
from u_4a_2s_p3d_raytracer_template2_tpu.core.types import Rays as JRays
from u_4a_2s_p3d_raytracer_template2_tpu_torch import native
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import bvh as pbvh
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import grid as pgrid
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import traverse
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect
from torch_parity import (  # one_torch_thread: an autouse fixture
    REFERENCE_COMPILE,
    jax_scene_to_port,
    mixed_scene,
    one_torch_thread,
    random_rays,
    soup,
)

CPU = torch.device("cpu")
N = 512


def _soup_mixed(sd):
    """The soup's spheres and triangles with mixed_scene's plane and box."""
    soup(sd, 60, 10, seed=3)
    m = sd.add_material([0.7, 0.7, 0.2], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    sd.add_plane_points([0, -4.5, 0], [1, -4.5, 0], [0, -4.5, -1], m)
    sd.add_box([-0.4, -0.5, -1.5], [0.6, 0.5, -0.6], m)
    return sd


def _tables(sd):
    scene = rt.build_scene(sd, accel=C.ACCEL_NONE)
    n = scene.n_objects
    return (np.asarray(scene.prims.params)[:n],
            np.asarray(scene.prims.ptype)[:n])


def _assert_same(port, jax_arrays, exclude=()):
    for f in port.__dataclass_fields__:
        got, want = getattr(port, f), getattr(jax_arrays, f)
        if f in exclude:
            continue
        if isinstance(got, int):
            assert got == want, f
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("kind", ["bvh", "grid"])
def test_builders_match_jax(kind, use_native):
    """The port's build equals the JAX package's, array for array, with
    the same builder (C++ or NumPy)."""
    if use_native and not native.available():
        pytest.skip("no g++ on this machine")
    for sd in (_soup_mixed(pt.SceneDef()),
               mixed_scene(pt.SceneDef(), res=8)):
        params, ptype = _tables(sd)
        if kind == "bvh":
            got = pbvh.build_bvh(params, ptype, device=CPU,
                                 use_native=use_native)
            want = jbvh.build_bvh(params, ptype, use_native=use_native)
        else:
            got = pgrid.build_grid(params, ptype, device=CPU,
                                   use_native=use_native)
            want = jgrid.build_grid(params, ptype, use_native=use_native)
        _assert_same(got, want)


def test_native_builders_match_numpy():
    """JAX's own check (tests/test_accel.py:90-125) on the port's copy:
    the C++ and NumPy builds give the same tree and the same cells."""
    if not native.available():
        pytest.skip("no g++ on this machine")
    assert native.library_path().parent.name == "native"
    params, ptype = _tables(_soup_mixed(pt.SceneDef()))
    b_nat = pbvh.build_bvh(params, ptype, device=CPU, use_native=True)
    b_py = pbvh.build_bvh(params, ptype, device=CPU, use_native=False)
    _assert_same(b_nat, b_py)
    g_nat = pgrid.build_grid(params, ptype, device=CPU, use_native=True)
    g_py = pgrid.build_grid(params, ptype, device=CPU, use_native=False)
    _assert_same(g_nat, g_py, exclude=("cell_items",))

    def cell_sets(items):
        return [frozenset(int(x) for x in row if x >= 0) for row in items]

    assert cell_sets(g_nat.cell_items.numpy()) == cell_sets(
        g_py.cell_items.numpy())


def _jax_fn(fn, o, d):
    """``fn(JRays)`` jitted at the reference compile options, as NumPy."""
    out = jax.jit(lambda o, d: fn(JRays.make(o, d))).lower(o, d).compile(
        compiler_options=REFERENCE_COMPILE)(o, d)
    return tuple(np.asarray(x) for x in out) if isinstance(
        out, tuple) else np.asarray(out)


def _scene_pair(accel):
    jscene = rt.build_scene(_soup_mixed(rt.SceneDef()), accel=accel)
    return jscene, jax_scene_to_port(jscene)


@pytest.mark.parametrize("accel", [C.ACCEL_BVH, C.ACCEL_GRID])
def test_perray_matches_jax_traversal(accel):
    """On one set of tables (carried by core/convert): closest-hit ids equal
    the JAX traversal's exactly and t within 1e-5; occlusion equal at
    max_t 1 and unbounded; dead rays read (BIG, -1) and occluded."""
    jscene, scene = _scene_pair(accel)
    if accel == C.ACCEL_BVH:
        assert scene.bvh is not None and scene.grid is None
        closest, any_hit = traverse.bvh_closest_hit, traverse.bvh_any_hit
        jclosest, jany = jtrav.bvh_closest_hit, jtrav.bvh_any_hit
        tables, jtables = scene.bvh, jscene.bvh
        _assert_same(tables, jtables)
    else:
        assert scene.grid is not None and scene.bvh is None
        closest, any_hit = traverse.grid_closest_hit, traverse.grid_any_hit
        jclosest, jany = jtrav.grid_closest_hit, jtrav.grid_any_hit
        tables, jtables = scene.grid, jscene.grid
        _assert_same(tables, jtables)
    o, d = random_rays(N, 11, -6.0, 6.0)
    rays = Rays.make(torch.from_numpy(o), torch.from_numpy(d))
    t, oid = closest(tables, scene.prims, rays)
    jt, jid = _jax_fn(lambda r: jclosest(jtables, jscene.prims, r), o, d)
    np.testing.assert_array_equal(oid.numpy(), jid)
    np.testing.assert_allclose(np.minimum(t.numpy(), 1e30),
                               np.minimum(jt, 1e30), rtol=1e-5, atol=1e-5)
    assert (jid >= 0).mean() > 0.3
    for max_t in (1.0, C.BIG):
        seg = Rays.make(rays.origin, rays.direction * 3.0)
        occ = any_hit(tables, scene.prims, seg, max_t)
        jocc = _jax_fn(lambda r: jany(jtables, jscene.prims, r, max_t), o,
                       d * 3.0)
        np.testing.assert_array_equal(occ.numpy(), jocc)
    dead = torch.from_numpy(np.arange(N) % 3 == 0)
    t_d, id_d = closest(tables, scene.prims, rays, dead)
    assert bool((t_d[dead] == C.BIG).all()) and bool((id_d[dead] == -1).all())
    assert torch.equal(id_d[~dead], oid[~dead])
    occ_d = any_hit(tables, scene.prims, rays, C.BIG, dead)
    assert bool(occ_d[dead].all())
    assert torch.equal(occ_d[~dead], any_hit(tables, scene.prims, rays,
                                             C.BIG)[~dead])


@pytest.mark.parametrize("accel", [C.ACCEL_BVH, C.ACCEL_GRID])
def test_perray_matches_brute_force(accel):
    """tests/test_accel.py's rule against the port's own brute force on a
    scene the port built: t within 1e-4, ids on 99.5% of rays."""
    scene = pt.build_scene(_soup_mixed(pt.SceneDef()), device=CPU,
                           accel=accel)
    o, d = random_rays(N, 5, -8.0, 8.0)
    rays = Rays.make(torch.from_numpy(o), torch.from_numpy(d))
    if accel == C.ACCEL_BVH:
        t, oid = traverse.bvh_closest_hit(scene.bvh, scene.prims, rays)
    else:
        t, oid = traverse.grid_closest_hit(scene.grid, scene.prims, rays)
    t_ref, id_ref = intersect.closest_hit_plain(scene.prims, rays)
    np.testing.assert_allclose(np.minimum(t.numpy(), 1e30),
                               np.minimum(t_ref.numpy(), 1e30), rtol=1e-4,
                               atol=1e-4)
    assert (oid == id_ref).float().mean() > 0.995
    stats = dict(traverse.stats)
    if accel == C.ACCEL_BVH:
        traverse.bvh_any_hit(scene.bvh, scene.prims, rays, 1.0)
    else:
        traverse.grid_any_hit(scene.grid, scene.prims, rays, 1.0)
    # one query, its walk checked by the host every CHECK_EVERY steps
    assert traverse.stats["queries"] == stats["queries"] + 1
    steps = traverse.stats["iterations"] - stats["iterations"]
    syncs = traverse.stats["syncs"] - stats["syncs"]
    assert steps == traverse.CHECK_EVERY * (syncs - 1)


def test_grid_quirk7_cross_cell_closest():
    """SURVEY quirk #7 (grid.cpp:262-307 carries closestObj across cells),
    the construction of tests/test_accel.py:153: a big sphere spanning many
    cells with a small one behind it; the DDA's ids equal brute force's."""
    sd = pt.SceneDef()
    sd.set_camera(eye=[0, 0, 20], at=[0, 0, 0], up=[0, 1, 0], fov=30,
                  hither=0.01, res_x=8, res_y=8, aperture_ratio=0,
                  focal_ratio=1)
    m = sd.add_material([0.8, 0.2, 0.2], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    sd.add_sphere([0.0, 0.0, 0.0], 4.0, m)
    sd.add_sphere([0.0, 0.0, -7.0], 1.0, m)
    for k in range(6):
        sd.add_sphere([3.5 * np.cos(k), 3.5 * np.sin(k), 2.0 - k], 0.3, m)
    sd.add_light([10, 10, 10], [1, 1, 1])
    scene = pt.build_scene(sd, device=CPU, accel=C.ACCEL_GRID)
    assert scene.grid is not None
    n = 64
    rng = np.random.default_rng(3)
    o = np.broadcast_to(np.array([0, 0, 20], np.float32), (n, 3)).copy()
    d = rng.normal(size=(n, 3)) * np.array([0.15, 0.15, 1.0])
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays = Rays.make(torch.from_numpy(o), torch.from_numpy(d))
    t_g, id_g = traverse.grid_closest_hit(scene.grid, scene.prims, rays)
    t_b, id_b = intersect.closest_hit_brute(scene.prims, rays)
    assert torch.equal(id_g, id_b)
    np.testing.assert_allclose(np.minimum(t_g.numpy(), 1e30),
                               np.minimum(t_b.numpy(), 1e30), rtol=1e-5)


def test_grid_initfail_matches_jax():
    """reference_grid_shadow_initfail: the shadow DDA of a segment whose
    grid entry fails occludes (grid.cpp:326-328), equal to JAX's
    grid_any_hit; without the quirk such a segment is lit."""
    jscene, scene = _scene_pair(C.ACCEL_GRID)
    o, d = random_rays(N, 17, -12.0, 12.0)
    rays = Rays.make(torch.from_numpy(o), torch.from_numpy(d))
    fails = None
    for quirk in (False, True):
        occ = traverse.grid_any_hit(scene.grid, scene.prims, rays, 1.0,
                                    init_fail_occludes=quirk)
        want = _jax_fn(lambda r: jtrav.grid_any_hit(
            jscene.grid, jscene.prims, r, 1.0, init_fail_occludes=quirk),
            o, d)
        np.testing.assert_array_equal(occ.numpy(), want)
        fails = occ if fails is None else occ & ~fails
    assert int(fails.sum()) > N // 10  # segments that miss the grid


@pytest.mark.parametrize("accel", [C.ACCEL_BVH, C.ACCEL_GRID])
def test_perray_render_matches_the_walk(accel):
    """accel_impl="perray" renders through the per-ray traversal and gives
    the walk's image; the grid quirk renders under every accel_impl."""
    sd = mixed_scene(pt.SceneDef(), res=12)
    scene = pt.build_scene(sd, device=CPU, accel=accel)
    want = pt.render_image(scene, pt.RenderConfig(max_depth=3))
    before = traverse.stats["queries"]
    got = pt.render_image(scene, pt.RenderConfig(max_depth=3,
                                                 accel_impl="perray"))
    assert traverse.stats["queries"] > before
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    if accel == C.ACCEL_GRID:
        imgs = [pt.render_image(scene, pt.RenderConfig(
            max_depth=3, accel_impl=impl, reference_grid_shadow_initfail=True))
            for impl in ("auto", "perray", "brute")]
        for img in imgs:
            assert bool(torch.isfinite(img).all())
            np.testing.assert_allclose(img.numpy(), imgs[0].numpy(),
                                       atol=1e-5)


def test_device_tool_grid_section_on_the_cpu():
    """tools/device_validate.grid: the DDA against the walk on a grid
    scene (times only on the card)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        device_validate as dv,
    )

    out = dv.grid(CPU, res=16, n_side=8)
    assert out["grid_dda_ms"] is None and out["walk_ms"] is None
    assert out["id_agree_frac"] == 1.0 and out["image_max_abs"] == 0.0
    assert out["dda_iterations"] > 0 and out["dda_syncs"] > 1
