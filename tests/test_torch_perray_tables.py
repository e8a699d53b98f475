"""The per-ray traversals' kernel-side pieces on the CPU: the primitive table
the kernels of csrc/perray_traverse.cu read (kernels.perray_rows), the
dispatch of accel/traverse.py (CPU tensors run the plain version), the
chip_smoke.py cases that hold the kernels against their plain version on
the card, and frames under accel_impl="perray" and
reference_grid_shadow_initfail as compiled programs on the stand-in graph
cache of tests/test_torch_graphs.py, against their eager frames and the
JAX package's traversals. One process, about 10 s:

    python -m pytest -n 0 --durations=5 tests/test_torch_perray_tables.py
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.accel import traverse as jtrav
from u_4a_2s_p3d_raytracer_template2_tpu.core.types import Rays as JRays
from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import traverse
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
    RenderConfig,
    Rays,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import whitted
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.intersect import (
    closest_hit_plain,
    per_ray_t,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs
from test_torch_graphs import FakeGraphs
from torch_parity import (  # one_torch_thread: an autouse fixture
    REFERENCE_COMPILE,
    jax_scene_to_port,
    mixed_scene,
    one_torch_thread,
    random_rays,
)

CPU = torch.device("cpu")
RES = 16
N = 512


@pytest.fixture
def fake(monkeypatch):
    """The compiled callables on CPU tensors through FakeGraphs: a fresh
    graph cache, and the CPU treated as the card."""
    cache = graphs.GraphCache(FakeGraphs())
    monkeypatch.setattr(graphs, "CACHE", cache)
    monkeypatch.setattr(graphs, "on_card", lambda device: True)
    return cache


def _mixed(accel, res=RES):
    return pt.build_scene(mixed_scene(pt.SceneDef(), res=res), device=CPU,
                          accel=accel)


def test_perray_rows_hold_what_per_ray_t_reads():
    """Row i of the kernels' table is object i: the 12 parameters of
    prims.params, its type and its id as int32 bits, two zero pads; the
    four types are there, and per_ray_t reads the same t from the rows as
    from the primitive table. The table carries no gradient."""
    scene = _mixed(C.ACCEL_BVH)
    prims = scene.prims
    params = prims.params.clone().requires_grad_()
    rows = kernels.perray_rows(dataclasses.replace(prims, params=params))
    n = prims.params.shape[0]
    assert rows.shape == (n, 16) and rows.dtype == torch.float32
    assert not rows.requires_grad and rows.is_contiguous()
    bits = rows.view(torch.int32)
    assert torch.equal(rows[:, :12], prims.params)
    assert torch.equal(bits[:, 12], prims.ptype)
    assert torch.equal(bits[:, 13], torch.arange(n, dtype=torch.int32))
    assert not bool(rows[:, 14:].any())
    live = prims.ptype[:scene.n_objects]
    assert set(live.tolist()) == {C.PLANE, C.TRIANGLE, C.SPHERE, C.AABOX}
    o, d = (torch.from_numpy(a) for a in random_rays(N, 3, -3.0, 3.0))
    ids = torch.arange(N) % scene.n_objects
    want = per_ray_t(prims.params[ids], prims.ptype[ids], o, d)
    got = per_ray_t(rows[ids, :12], bits[ids, 12], o, d)
    assert torch.equal(got, want)
    assert bool((want < C.BIG).any())


@pytest.mark.parametrize("masked", [False, True], ids=["all", "dead"])
@pytest.mark.parametrize("accel", [C.ACCEL_BVH, C.ACCEL_GRID],
                         ids=["bvh", "grid"])
def test_dispatchers_on_cpu_tensors_are_the_plain_version(accel, masked):
    """On CPU tensors bvh_closest_hit, bvh_any_hit, grid_closest_hit and
    grid_any_hit (with and without the initfail quirk) answer as their
    plain version, bit for bit, with and without a dead mask."""
    scene = _mixed(accel)
    o, d = (torch.from_numpy(a) for a in random_rays(N, 9, -4.0, 4.0))
    rays = Rays.make(o, d)
    seg = Rays.make(o, d * 3.0)
    dead = torch.arange(N) % 4 == 1 if masked else None
    if accel == C.ACCEL_BVH:
        pairs = [(traverse.bvh_closest_hit(scene.bvh, scene.prims, rays,
                                           dead),
                  traverse.bvh_closest_plain(scene.bvh, scene.prims, rays,
                                             dead))]
        pairs += [(traverse.bvh_any_hit(scene.bvh, scene.prims, seg, max_t,
                                        dead),
                   traverse.bvh_any_plain(scene.bvh, scene.prims, seg,
                                          max_t, dead))
                  for max_t in (1.0, C.BIG)]
    else:
        pairs = [(traverse.grid_closest_hit(scene.grid, scene.prims, rays,
                                            dead),
                  traverse.grid_closest_plain(scene.grid, scene.prims, rays,
                                              dead))]
        pairs += [(traverse.grid_any_hit(scene.grid, scene.prims, seg, 1.0,
                                         dead, quirk),
                   traverse.grid_any_plain(scene.grid, scene.prims, seg, 1.0,
                                           dead, quirk))
                  for quirk in (False, True)]
    for got, want in pairs:
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    t, oid = pairs[0][0]
    assert oid.dtype == torch.int32 and bool((oid >= 0).any())
    if masked:
        assert bool((t[dead] == C.BIG).all() and (oid[dead] == -1).all())
        assert bool(pairs[1][0][dead].all())


def test_corner_grid_case_is_decided_by_the_exit_axis_tie():
    """chip_smoke.corner_grid_scene, the case the DDA's axis-tie fault must
    fail: the sphere is listed only in cell (1, 0, 0), the rays tie x and z
    at every corner, and the plain DDA, which steps x first, finds the
    sphere on every ray that meets it (brute force's hits, with its t)."""
    scene, o, d = chip_smoke.corner_grid_scene(CPU, n=256)
    t, oid = traverse.grid_closest_hit(scene.grid, scene.prims,
                                       Rays.make(o, d))
    t_b, id_b = closest_hit_plain(scene.prims, Rays.make(o, d))
    assert torch.equal(oid, id_b) and torch.equal(t, t_b)
    assert 0 < int((oid == 0).sum()) < 256
    occ = traverse.grid_any_hit(scene.grid, scene.prims, Rays.make(o, d),
                                C.BIG)
    assert torch.equal(occ, oid == 0)


def test_chip_smoke_perray_cases_on_the_cpu():
    """chip_smoke.perray_cases at a small size on CPU tensors: all 35
    cases run through the plain version, the closest-hit cases hit, and
    perray_agreement reads 0 on a plain answer against itself."""
    n_cases = 0
    for label, kind, scene, query, args in chip_smoke.perray_cases(
            CPU, res=8, n_side=6, n_rays=128):
        want = chip_smoke.perray_run(kind, query, scene, args, kernel=False)
        reading = chip_smoke.perray_agreement(
            query, want, want, chip_smoke.dead_of(query, args))
        assert not chip_smoke.rejects(reading, chip_smoke.PERRAY_LIMITS)
        if query == "closest":
            assert bool((want[1] >= 0).any()), label
        n_cases += 1
    assert n_cases == 35


def _jax_fn(fn, o, d):
    out = jax.jit(lambda o, d: fn(JRays.make(o, d))).lower(o, d).compile(
        compiler_options=REFERENCE_COMPILE)(o, d)
    return tuple(np.asarray(x) for x in out) if isinstance(
        out, tuple) else np.asarray(out)


_PATHS = {"P1": (C.ACCEL_BVH, False), "P2": (C.ACCEL_GRID, False),
          "P2q": (C.ACCEL_GRID, True)}


@pytest.mark.parametrize("path", list(_PATHS))
def test_perray_frames_capture_once_and_match_jax(fake, path):
    """P1 (the median BVH), P2 (the grid DDA) and P2q (P2 under
    reference_grid_shadow_initfail) at 16x16, depth 4, on JAX's own tables
    (core/convert): render_image captures one program for a frame and for
    a moved camera, each replay equal to the eager frame; the traversal of
    the frame's primary rays (P2q: its shadow DDA with the quirk, on
    segments many of which miss the grid) equals the JAX package's."""
    accel, quirk = _PATHS[path]
    jscene = rt.build_scene(mixed_scene(rt.SceneDef(), res=RES),
                            accel=accel)
    scene = jax_scene_to_port(jscene)
    cfg = RenderConfig(accel_impl="perray",
                       reference_grid_shadow_initfail=quirk)
    px, py = whitted.pixel_grid(RES, RES, CPU)
    cam = scene.camera
    moved = dataclasses.replace(scene, camera=dataclasses.replace(
        cam, eye=cam.eye + torch.tensor([0.3, -0.2, 0.1])))
    for s in (scene, moved):
        got = whitted.render_image(s, cfg)
        want = whitted.render_tile(s, px, py, cfg).reshape(RES, RES, 3)
        assert torch.equal(got, want)
    assert fake.captures == 1
    assert bool(torch.isfinite(got).all())
    o, d = chip_smoke.camera_rays(scene)
    if quirk:
        o, d = (torch.from_numpy(a) for a in random_rays(N, 17, -12.0, 12.0))
        occ = traverse.grid_any_hit(scene.grid, scene.prims,
                                    Rays.make(o, d), 1.0,
                                    init_fail_occludes=True)
        want = _jax_fn(lambda r: jtrav.grid_any_hit(
            jscene.grid, jscene.prims, r, 1.0, init_fail_occludes=True),
            o.numpy(), d.numpy())
        np.testing.assert_array_equal(occ.numpy(), want)
        return
    tables, jtables = ((scene.bvh, jscene.bvh) if accel == C.ACCEL_BVH
                       else (scene.grid, jscene.grid))
    closest = (traverse.bvh_closest_hit if accel == C.ACCEL_BVH
               else traverse.grid_closest_hit)
    jclosest = (jtrav.bvh_closest_hit if accel == C.ACCEL_BVH
                else jtrav.grid_closest_hit)
    t, oid = closest(tables, scene.prims, Rays.make(o, d))
    jt, jid = _jax_fn(lambda r: jclosest(jtables, jscene.prims, r),
                      o.numpy(), d.numpy())
    np.testing.assert_array_equal(oid.numpy(), jid)
    np.testing.assert_allclose(np.minimum(t.numpy(), 1e30),
                               np.minimum(jt, 1e30), rtol=1e-5, atol=1e-5)
    assert (jid >= 0).mean() > 0.5
