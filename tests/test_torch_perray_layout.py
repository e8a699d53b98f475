"""The per-ray kernels' tables on the CPU, as csrc/perray_traverse.cu reads
them: the median BVH packed as 64 B records numbered breadth first
(kernels.perray_bvh_table), the primitive rows in the tree's object order
(perray_bvh_rows), the grid's items in int4s with their counts
(perray_grid_table); the primitives' table packed once a Primitives
object (_prims_rows); the wrappers' refusals on the CPU; and a walk over
the packed records written one ray at a time as the kernel walks them,
against the plain version (accel/traverse.py) and the JAX package's
traversal. One process, under 40 s:

    python -m pytest -n 0 --durations=5 tests/test_torch_perray_layout.py
"""
import dataclasses
import functools
import re
from pathlib import Path

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
    GridArrays,
    Rays,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    sphere_field_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.intersect import _safe_inv
from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import megakernels as mt
from torch_parity import (  # one_torch_thread: an autouse fixture
    REFERENCE_COMPILE,
    jax_scene_to_port,
    mixed_scene,
    one_torch_thread,
    random_rays,
)

CPU = torch.device("cpu")
SOURCE = (Path(kernels.__file__).resolve().parent.parent / "csrc"
          / "perray_traverse.cu")
BIG = np.float32(C.BIG)


@functools.cache
def _scene(name, accel=C.ACCEL_BVH):
    """A scene of the file's tests, built once: its tables packed once."""
    if name == "field":
        return pt.build_scene(sphere_field_scene(n_side=16, res=32,
                                                 accel=accel), device=CPU)
    if name == "mixed":
        return pt.build_scene(mixed_scene(pt.SceneDef(), res=16), device=CPU,
                              accel=accel)
    return chip_smoke.deep_tree_scene(CPU, n=64)[0]


def _tree(bvh):
    """{inner node reachable from the root: its depth}, by a depth-first
    walk of the arrays."""
    leaf, index = bvh.leaf.numpy(), bvh.index.numpy()
    K = leaf.shape[0]
    depth, stack = {}, [] if leaf[0] else [(0, 0)]
    while stack:
        n, dep = stack.pop()
        depth[n] = dep
        for c in (index[n], min(index[n] + 1, K - 1)):
            if not leaf[c]:
                stack.append((c, dep + 1))
    return depth


@pytest.mark.parametrize("name", ["field", "mixed", "deep"])
def test_node_table_maps_back_to_the_tree(name):
    """Record 0 holds the root's box and reference; record r >= 1 holds
    inner node node_ids[r]: its left and right child's boxes bit for bit,
    and each child's index and meta: an inner child's record (whose node
    is that child) and -1, or a leaf's first row and object count."""
    bvh = _scene(name).bvh
    table = kernels.perray_bvh_table(bvh)
    f = table.nodes.numpy()
    bits = f.view(np.int32)
    lo, hi = bvh.bbox_min.numpy(), bvh.bbox_max.numpy()
    leaf, index = bvh.leaf.numpy(), bvh.index.numpy()
    n_objs = bvh.n_objs.numpy()
    ids = table.node_ids.numpy()
    K = leaf.shape[0]
    assert table.nodes.shape == (ids.size, 16) and table.nodes.dtype == \
        torch.float32 and ids[0] == 0
    np.testing.assert_array_equal(f[0, 0:3], lo[0])
    np.testing.assert_array_equal(f[0, 3:6], hi[0])

    def check(child, idx, meta):
        if leaf[child]:
            assert (idx, meta) == (index[child], n_objs[child])
        else:
            assert meta == -1 and ids[idx] == child

    check(0, bits[0, 12], bits[0, 14])
    for r in range(1, ids.size):
        n = ids[r]
        assert not leaf[n]
        left, right = index[n], min(index[n] + 1, K - 1)
        for child, box, col in ((left, slice(0, 6), 12),
                                (right, slice(6, 12), 13)):
            np.testing.assert_array_equal(
                f[r, box], np.concatenate([lo[child], hi[child]]))
            check(child, bits[r, col], bits[r, col + 2])
    assert table.n_order == bvh.order.numel()


@pytest.mark.parametrize("name", ["field", "mixed", "deep"])
def test_breadth_first_numbering_is_a_permutation_that_keeps_the_tree(name):
    """The records' nodes are the reachable inner nodes, each once, level
    by level (the top levels a prefix); every inner child's record comes
    after its parent's."""
    bvh = _scene(name).bvh
    table = kernels.perray_bvh_table(bvh)
    depth = _tree(bvh)
    ids = table.node_ids.numpy()[1:]
    assert sorted(ids.tolist()) == sorted(depth)
    levels = [depth[n] for n in ids]
    assert levels == sorted(levels)
    bits = table.nodes.numpy().view(np.int32)
    for r in range(1, ids.size + 1):
        for col in (12, 13):
            if bits[r, col + 2] < 0:
                assert bits[r, col] > r


def test_kernel_stack_is_the_plain_walks():
    """The kernels' stack holds accel/traverse.STACK entries, the plain
    version's, so that a push past it lands in the same top slot."""
    text = SOURCE.read_text()
    assert int(re.search(r"constexpr int kStack = (\d+);",
                         text).group(1)) == traverse.STACK == 64


@pytest.mark.parametrize("fault", ["child", "leaf"])
def test_node_table_refuses_indices_out_of_range(fault):
    """perray_bvh_table raises ValueError where an inner node's child or
    a leaf's first object lies outside the arrays the kernels read."""
    bvh = _scene("field").bvh
    index, leaf = bvh.index.clone(), bvh.leaf.numpy()
    if fault == "child":
        index[0] = leaf.shape[0] + 5
    else:
        index[int(np.flatnonzero(leaf)[0])] = -3
    with pytest.raises(ValueError, match="out of range"):
        kernels.perray_bvh_table(dataclasses.replace(bvh, index=index))


@pytest.mark.parametrize("wrapper", ["perray_bvh_closest", "perray_bvh_any",
                                     "grid_closest", "grid_any"])
def test_wrappers_refuse_cpu_tensors(wrapper):
    """The per-ray wrappers launch on CUDA tensors only: on CPU tensors
    each raises ValueError, with no fallback to the plain version."""
    kind = C.ACCEL_BVH if "bvh" in wrapper else C.ACCEL_GRID
    scene = _scene("field", kind)
    accel = scene.bvh if "bvh" in wrapper else scene.grid
    o, d = chip_smoke.camera_rays(scene)
    args = (o, d) if wrapper.endswith("closest") else (o, d, 1.0)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        getattr(kernels, wrapper)(accel, scene.prims, *args)


@pytest.mark.parametrize("layout", ["packed", "arrays"])
def test_tool_reads_the_layout_of_a_source(layout, tmp_path):
    """tools/megakernels.perray_layout: this checkout's source walks the
    packed tables; a source whose BVH entry point takes the JAX package's
    arrays (commit efff919's) is called through the arrays layout."""
    if layout == "packed":
        assert mt.perray_layout(SOURCE.parent) == "packed"
        return
    (tmp_path / "perray_traverse.cu").write_text(
        'extern "C" int median_bvh_closest_launch(\n'
        "    void* stream, const float* o, const float* d, int n_rays,\n"
        "    const uint8_t* dead, const float* bmin, const float* bmax,\n"
        "    const uint8_t* leaf, const int* index, const int* n_objs, "
        "int K,\n")
    assert mt.perray_layout(tmp_path) == "arrays"


@pytest.mark.parametrize("name", ["field", "mixed"])
def test_walk_rows_are_the_rows_in_tree_order(name):
    """perray_bvh_rows: row j < n_order is row order[j] of perray_rows (id
    -1 where the order is padded), then the planes' rows (id -1 where
    their ids are padded)."""
    scene = _scene(name)
    bvh = scene.bvh
    rows = kernels.perray_rows(scene.prims)
    walk = kernels.perray_bvh_rows(bvh, scene.prims)
    objects = torch.cat([bvh.order, bvh.unbounded_ids])
    assert walk.shape == (objects.numel(), 16)
    have = objects >= 0
    assert torch.equal(walk[have], rows[objects[have].long()])
    assert bool((walk.view(torch.int32)[~have, 13] == -1).all())
    assert bool((~have[:bvh.order.numel()]).any())  # the order is padded
    if name == "mixed":
        assert int(have[bvh.order.numel():].sum()) == 1  # the plane


@pytest.mark.parametrize("kind", ["bvh", "grid"])
def test_rows_are_packed_once_a_primitives_object(kind):
    """kernels._prims_rows, the table the wrappers read: perray_bvh_rows
    (the tree's order) or perray_rows (by id), the same tensor on every
    call with the same primitives (a frame's 12 queries share one pack);
    new primitives (dataclasses.replace) are packed anew, and params that
    require grad on every call, detached."""
    scene = pt.build_scene(mixed_scene(pt.SceneDef(), res=16), device=CPU,
                           accel=C.ACCEL_BVH if kind == "bvh"
                           else C.ACCEL_GRID)
    bvh = scene.bvh if kind == "bvh" else None

    def pack(prims):
        return (kernels.perray_rows(prims) if bvh is None
                else kernels.perray_bvh_rows(bvh, prims))

    def same(a, b):  # bit for bit: the int32 columns read as NaN floats
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    rows = kernels._prims_rows(scene.prims, bvh)
    assert same(rows, pack(scene.prims))
    assert kernels._prims_rows(scene.prims, bvh) is rows
    moved = dataclasses.replace(scene.prims, params=scene.prims.params * 2)
    got = kernels._prims_rows(moved, bvh)
    assert got is not rows and same(got, pack(moved))
    assert not same(got, rows)
    assert kernels._prims_rows(scene.prims, bvh) is rows
    grad = dataclasses.replace(
        scene.prims, params=scene.prims.params.clone().requires_grad_())
    a, b = kernels._prims_rows(grad, bvh), kernels._prims_rows(grad, bvh)
    assert a is not b and same(a, rows) and not a.requires_grad


def _hand_grid(items):
    items = torch.tensor(items, dtype=torch.int32)
    return GridArrays(bbox_min=torch.zeros(3), bbox_max=torch.ones(3),
                      cell_items=items,
                      cell_count=(items >= 0).sum(dim=1).int(),
                      unbounded_ids=torch.full((8,), -1, dtype=torch.int32),
                      nx=items.shape[0], ny=1, nz=1,
                      max_per_cell=items.shape[1])


@pytest.mark.parametrize("name", ["field", "mixed", "hand"])
def test_grid_items_in_int4s_with_their_counts(name):
    """perray_grid_table: each cell's items in their order, -1 padded to a
    multiple of 4 columns, and their count: the grid's own items and
    counts (accel/grid.build_grid packs each cell's items first); a hand grid of 5
    slots with -1 between items keeps its items' order."""
    if name == "hand":
        grid = _hand_grid([[3, -1, 4, -1, 5], [-1, -1, -1, -1, -1],
                           [7, 8, 9, 10, 11], [-1, 2, -1, -1, -1]])
    else:
        grid = _scene(name, C.ACCEL_GRID).grid
    table = kernels.perray_grid_table(grid)
    n, m = grid.cell_items.shape
    assert table.items.dtype == table.count.dtype == torch.int32
    assert table.items.shape == (n, 4 * -(-m // 4))
    assert torch.equal(table.count, grid.cell_count)
    assert bool((table.items[:, m:] == -1).all())
    if name == "hand":
        assert table.items.tolist() == [[3, 4, 5, -1, -1, -1, -1, -1],
                                        [-1] * 8,
                                        [7, 8, 9, 10, 11, -1, -1, -1],
                                        [2, -1, -1, -1, -1, -1, -1, -1]]
    else:
        assert m % 4 == 0 and torch.equal(table.items[:, :m],
                                          grid.cell_items)
    assert kernels.perray_grid_table(grid) is table  # packed once a grid


# ---------------------------------------------------------------------------
# the kernel's walk over the packed records, one ray at a time


def _box(f, o, inv):
    """box_enter: (hit, entry t, origin strictly inside) of the box f[0:6]
    in f32, as the kernel's slab test."""
    lo, hi = f[0:3], f[3:6]
    a, b = (lo - o) * inv, (hi - o) * inv
    pos = inv >= 0
    t0 = np.max(np.where(pos, a, b))
    t1 = np.min(np.where(pos, b, a))
    inside = bool(((o > lo) & (o < hi)).all())
    return bool(t0 < t1 and t1 > 0), (t1 if t0 < 0 else t0), inside


def _ref(index, meta):
    return int(index) if meta < 0 else ~(int(index) * 8 + min(int(meta), 4))


def _walk(table, ids, t_obj, o, inv, stack_n, max_t=None):
    """(t, id) of one ray's walk of ``table`` as csrc/perray_traverse.cu's
    bvh_walk takes it; ``ids`` the walk rows' objects, ``t_obj`` the ray's
    t of each object."""
    f = table.nodes.numpy()
    bits = f.view(np.int32)
    tb, ib = BIG, -1
    hit, _, _ = _box(f[0, 0:6], o, inv)
    if not hit:
        return tb, ib
    cur, stack, sp = _ref(bits[0, 12], bits[0, 14]), [None] * stack_n, 0
    while True:
        if cur < 0:
            first, count = (~cur) >> 3, (~cur) & 7
            lt, lid = BIG, -1
            for k in range(min(count, 4)):
                oid = ids[min(first + k, table.n_order - 1)]
                t = t_obj[oid] if oid >= 0 else BIG
                if t < lt:
                    lt, lid = t, oid
            if lt < tb:
                tb, ib = lt, lid
            cur = 0
        else:
            lhit, ldist, lin = _box(f[cur, 0:6], o, inv)
            rhit, rdist, rin = _box(f[cur, 6:12], o, inv)
            ldist = np.float32(0) if lin else ldist
            rdist = np.float32(0) if rin else rdist
            lhit, rhit = lhit and ldist <= tb, rhit and rdist <= tb
            li = _ref(bits[cur, 12], bits[cur, 14])
            ri = _ref(bits[cur, 13], bits[cur, 15])
            if lhit and rhit:
                first = ldist < rdist
                stack[min(sp, stack_n - 1)] = ((ri, rdist) if first
                                               else (li, ldist))
                sp += 1
                cur = li if first else ri
            else:
                cur = li if lhit else (ri if rhit else 0)
        if max_t is not None and tb < max_t:
            break
        while cur == 0 and sp > 0:
            sp -= 1
            n, t = stack[min(sp, stack_n - 1)]
            if t < tb:
                cur = n
        if cur == 0:
            break
    return tb, ib


def _walk_all(scene, o, d, max_t=None, stack_n=traverse.STACK):
    """The packed walk of every ray (o, d) with the planes beside it, as
    the kernels answer: (t, id) int32, or occlusion where ``max_t`` is
    given; ``stack_n`` the stack's entries."""
    table = kernels.perray_bvh_table(scene.bvh)
    ids = table.objects.numpy()
    n = scene.prims.params.shape[0]
    t_obj = traverse._pair_t(scene.prims, torch.arange(n)[None].expand(
        o.shape[0], n), o, d).numpy()
    inv = _safe_inv(d).numpy()
    planes = [p for p in ids[table.n_order:] if p >= 0]
    out_t, out_id = [], []
    for i in range(o.shape[0]):
        t, oid = _walk(table, ids, t_obj[i], o[i].numpy(), inv[i], stack_n,
                       max_t)
        for p in planes:  # a plane's hit only at a strictly smaller t
            if t_obj[i, p] < t:
                t, oid = t_obj[i, p], p
        out_t.append(t)
        out_id.append(-1 if t >= BIG else oid)
    t = torch.tensor(np.array(out_t, np.float32))
    if max_t is not None:
        return t < max_t
    return t, torch.tensor(out_id, dtype=torch.int32)


@pytest.mark.parametrize("name", ["field", "mixed", "deep"])
def test_packed_walk_answers_as_the_plain_version(name):
    """The kernel's walk over the packed records and the walk rows gives
    the plain version's (t, id) and occlusion bit for bit: the field's
    camera rays (jittered), the four-type scene's incoherent rays and
    segments, deep_tree_scene's rays along its chain (on the kernels'
    64-entry stack)."""
    scene = _scene(name)
    if name == "deep":
        _, o, d = chip_smoke.deep_tree_scene(CPU, n=48)
    elif name == "field":
        o, d = chip_smoke.camera_rays(scene)
        pick = torch.arange(0, o.shape[0], 7)
        o, d = o[pick], d[pick] + 0.02 * torch.sin(
            torch.arange(3 * pick.numel()).reshape(-1, 3) * 1.3)
    else:
        o, d = (torch.from_numpy(a) for a in random_rays(160, 9, -4.0, 4.0))
    rays = Rays.make(o, d)
    t, oid = _walk_all(scene, o, d)
    t_p, id_p = traverse.bvh_closest_plain(scene.bvh, scene.prims, rays)
    assert torch.equal(oid, id_p) and torch.equal(t, t_p)
    assert bool((oid >= 0).any())
    for max_t in (1.0, C.BIG):
        seg = Rays.make(o, d * 3.0)
        occ = _walk_all(scene, o, d * 3.0, max_t=max_t)
        assert torch.equal(occ, traverse.bvh_any_plain(
            scene.bvh, scene.prims, seg, max_t))


def test_deep_tree_needs_the_long_stack():
    """deep_tree_scene, the case chip_faults' planted 16-entry stack must
    fail: the walk on 16 entries (or 21) loses the pushed entry of sphere
    DEEP_HIT, and every ray misses or reads unoccluded; on the kernels' 64
    entries (or 22) every ray hits it, as the plain version does."""
    scene, o, d = chip_smoke.deep_tree_scene(CPU, n=24)
    rays = Rays.make(o, d)
    t_p, id_p = traverse.bvh_closest_plain(scene.bvh, scene.prims, rays)
    assert bool((id_p == chip_smoke.DEEP_HIT - 1).all())
    for n in (16, 21):
        _, short = _walk_all(scene, o, d, stack_n=n)
        assert bool((short == -1).all())
    assert torch.equal(_walk_all(scene, o, d, stack_n=22)[1], id_p)
    assert not bool(_walk_all(scene, o, d, max_t=C.BIG, stack_n=16).any())
    assert bool(traverse.bvh_any_plain(scene.bvh, scene.prims, rays,
                                       C.BIG).all())


def test_packed_walk_answers_as_jax():
    """The packed walk of JAX's own tree (core/convert) of the four-type
    scene answers as the JAX package's bvh_closest_hit: the same ids, t
    within f32 reordering."""
    jscene = rt.build_scene(mixed_scene(rt.SceneDef(), res=16),
                            accel=C.ACCEL_BVH)
    scene = jax_scene_to_port(jscene)
    o, d = random_rays(96, 21, -4.0, 4.0)
    jt, jid = jax.jit(lambda o, d: jtrav.bvh_closest_hit(
        jscene.bvh, jscene.prims, JRays.make(o, d))).lower(o, d).compile(
            compiler_options=REFERENCE_COMPILE)(o, d)
    t, oid = _walk_all(scene, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(oid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(np.minimum(t.numpy(), 1e30),
                               np.minimum(np.asarray(jt), 1e30), rtol=1e-5,
                               atol=1e-5)
    assert (np.asarray(jid) >= 0).mean() > 0.3
