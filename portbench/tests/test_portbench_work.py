"""The frozen work models: counts on hand-checked shapes, the same counts
whatever blocks the reference tests in, and bounds that charge only the
work the inputs need; the guard against the JAX package."""
from __future__ import annotations

import sys
import types

import pytest
import torch

from portbench import harness, scenes, work
from portbench.reference import whitted as ref

CPU = torch.device("cpu")


def _one_sphere_scene():
    d = scenes.Description(
        camera=scenes._camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 45, 4, 1),
        bg=torch.zeros(3).numpy())
    m = d.material([1, 1, 1], 1, [1, 1, 1], 0, 10, 0, 1)
    d.sphere([0, 0, 0], 1.0, m)
    d.sphere([0, 0, -3], 1.0, m)
    d.triangle([-1, -1, -6], [1, -1, -6], [0, 1, -6], m)
    d.light([0, 0, 10], [1, 1, 1])
    return ref.build(d, CPU)


def test_closest_hit_charges_every_row_by_where_it_ended():
    rs = _one_sphere_scene()
    o = torch.tensor([[0.0, 0.0, 5.0], [5.0, 5.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    stats = {"queries": []}
    t, ids = ref.closest_hit(rs, o, d, torch.zeros(2, dtype=torch.bool),
                             stats)
    assert ids.tolist() == [0, -1] and float(t[0]) == pytest.approx(4.0)
    q = stats["queries"][0]
    # ray 0: triangle hit (all gates, with t), spheres hit (roots);
    # ray 1: triangle out at the u gate, spheres at the discriminant
    assert q == dict(kind="closest", live=2, hits=1,
                     stages=[0, 1, 0, 1, 2, 2])
    assert work.query_flops(q["stages"]) == 28 + 53 + 2 * 21 + 2 * 31
    assert work.query_bytes("closest", 2, 2, 2, 1) == 40 + 48 + 48 + 18


def test_any_hit_stops_at_its_first_occluder_in_table_order():
    rs = _one_sphere_scene()
    o = torch.tensor([[0.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -20.0]])
    stats = {"queries": []}
    occ = ref.any_hit(rs, o, d, 1.0, torch.zeros(1, dtype=torch.bool),
                      stats)
    assert occ.tolist() == [True]
    # the triangle first (it occludes at t 0.55), so no sphere is tested
    assert stats["queries"][0]["stages"] == [0, 0, 0, 1, 0, 0]


def test_dead_rays_cost_no_operations():
    rs = _one_sphere_scene()
    o = torch.tensor([[0.0, 0.0, 5.0]] * 4)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    dead = torch.tensor([False, True, True, True])
    stats = {"queries": []}
    ref.closest_hit(rs, o, d, dead, stats)
    q = stats["queries"][0]
    assert q["live"] == 1 and sum(q["stages"]) == 3


def _flake_queries():
    rs = ref.build(scenes.spd_balls(size=1, res=16), CPU)
    stats = {}
    ref.render(rs, 4, stats)
    return stats["queries"]


def test_counts_do_not_depend_on_how_the_tests_are_blocked(monkeypatch):
    base = _flake_queries()
    monkeypatch.setattr(ref, "CHUNK", 3)
    monkeypatch.setattr(ref, "BLOCK", 40)
    assert _flake_queries() == base


def test_walk_bound_is_bytes_and_below_brute_force():
    q = _flake_queries()
    slots, n_sph, n_tri = 256, 10, 2
    walk = work.walk_work(q, slots, n_sph, n_tri)
    brute = work.brute_work(q, slots, n_sph, n_tri)
    assert 0 < walk <= brute
    assert walk == pytest.approx(sum(
        work.query_bytes(x["kind"], x["live"], slots, n_sph, n_tri)
        for x in q) / work.PEAK_BYTES * 1e3)


def test_roofline_reads_bound_over_time_and_nothing_without_time():
    from portbench.trace import Trace

    read = harness.reader("brute_roofline")
    tr = Trace(units=2, window_s=1.0, busy_s=0.5, device_ops=4,
               launch_calls=2, kernel_us={"void brute_closest_sweep<1>": 400.0,
                                          "other": 100.0}, breakdown={})
    out = types.SimpleNamespace(trace=tr, work=lambda kind: 0.1)
    assert read(out) == pytest.approx(100 * 0.1 / 2 / 0.2)
    tr.kernel_us = {"other": 100.0}
    assert read(out) is None


def test_guard_names_jax_and_the_jax_package_only(monkeypatch):
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, harness.PROGRAM + ".core",
                        types.ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(
        sys.modules, "u_4a_2s_p3d_raytracer_template2_tpu.models",
        types.ModuleType("x"))
    assert harness.forbidden_loaded() == [
        "jax", "u_4a_2s_p3d_raytracer_template2_tpu"]
