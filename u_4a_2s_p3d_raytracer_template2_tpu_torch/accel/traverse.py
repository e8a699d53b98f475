"""The reference's per-ray accelerator traversals: the stack walk of the
spatial-median BVH and the Amanatides–Woo DDA of the uniform grid over the
flat arrays of accel/bvh.py and accel/grid.py; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/accel/traverse.py`` (lines 70-365
there: vmapped ``lax.while_loop`` programs, XLA code, not Pallas).

Reference semantics: BVH::Traverse (bvh.cpp:252-416): ordered two-child
descent with a (node, t) stack of ``STACK`` entries, a child's entry
distance forced to 0 when the origin is strictly inside its box
(bvh.cpp:292-293), children pruned with ``dist <= t_best``, a popped entry
taken only if ``< t_best``, leaves of at most ``LEAF_MAX`` objects (the
build's threshold is 2); Grid::Traverse (grid.cpp:101-361): the DDA
accepts a cell's closest hit only inside the cell's slab and carries the
closest object across cells (quirk #7; ``tests/test_accel.py:153``), and
the shadow DDA stops at the first object with t < max_t, a failed grid
entry occluding under ``init_fail_occludes`` (grid.cpp:326-328). Planes,
which have no box, are tested beside the tree or grid
(``_unbounded_closest``). Within a leaf or a cell the first object at the
smallest t wins, as the reference's ascending strict ``<`` scan.

``bvh_closest_hit``, ``bvh_any_hit``, ``grid_closest_hit`` and
``grid_any_hit`` dispatch by device: CUDA tensors launch the hand-written
kernels of ``csrc/perray_traverse.cu`` (``kernels.perray_bvh_closest``,
``perray_bvh_any``, ``grid_closest``, ``grid_any``: one thread a ray, its
loop on the device, the tree or grid packed once for the kernels and
kept on it (``kernels.perray_bvh_table``, ``perray_grid_table``; the
tree's pack reads the host), the primitives' table packed once a
``Primitives`` object, ``kernels._prims_rows``),
which read nothing back to the host after a tree's first query, so a
frame of them is one CUDA graph; CPU tensors run the ``*_plain``
functions below, their plain version, which the kernels answer bit for
bit. There is no fallback from one to the other.

The plain version steps every live ray once an iteration, as a handful of
[n]-wide tensor ops. Every ``CHECK_EVERY`` iterations the host reads which
rays are still live (one sync), stops when none is, and otherwise carries
on with those rays only, so rays that finished early cost nothing more.
``stats`` counts its queries, iterations and those syncs. ``dead`` [R] bool
marks rays the caller masks downstream: they are not traced and read
(BIG, -1), or occluded, as in the port's other traversals. The traversals
are discrete: the entry points read the rays detached and run without
autograd, so their answers carry no gradient (the shading re-derives t
from the winner, ``per_ray_t``).
"""
from __future__ import annotations

import torch

from ..core import constants as C
from ..core.types import BvhArrays, GridArrays, Primitives, Rays
from ..ops.intersect import _safe_inv, per_ray_t

STACK = 64
LEAF_MAX = 4
# iterations between the host's reads of the live rays: the loop syncs
# once every CHECK_EVERY steps
CHECK_EVERY = 8

stats = {"queries": 0, "iterations": 0, "syncs": 0}


def _present(prims: Primitives):
    return (prims.n_sph > 0, prims.n_tri > 0, prims.n_pl > 0,
            prims.n_box > 0)


def _pair_t(prims: Primitives, ids, o, d):
    """[n, m] t of the rays (o, d) [n, 3] against the objects ``ids`` [n, m]
    (-1: none, t BIG)."""
    n, m = ids.shape
    safe = ids.clamp(min=0).long()
    params = prims.params[safe].reshape(n * m, -1)
    ptype = torch.where(ids >= 0, prims.ptype[safe], C.INVALID).reshape(-1)
    t = per_ray_t(params, ptype, o[:, None, :].expand(n, m, 3).reshape(-1, 3),
                  d[:, None, :].expand(n, m, 3).reshape(-1, 3),
                  _present(prims))
    return t.reshape(n, m)


def _first_min(t, ids):
    """(smallest t of each row, its id; -1 where it is BIG): the first
    column at the smallest t, as an ascending strict ``<`` scan keeps."""
    t_min, k = t.min(dim=1)
    oid = ids.gather(1, k[:, None])[:, 0]
    return t_min, torch.where(t_min < C.BIG, oid, -1)


def _unbounded_closest(prims: Primitives, ids, o, d):
    """Closest hit of the (few) unbounded primitives, planes: (t, id)."""
    if prims.n_pl == 0:  # the only unbounded type
        return (torch.full(o.shape[:1], C.BIG, dtype=o.dtype,
                           device=o.device),
                torch.full(o.shape[:1], -1, dtype=torch.int64,
                           device=o.device))
    ids = ids[None, :].expand(o.shape[0], -1).long()
    return _first_min(_pair_t(prims, ids, o, d), ids)


def _run(state: dict, step, outputs: dict) -> None:
    """Step the rays of ``state`` (a dict of [n, ...] tensors with ``idx``,
    the rays' indices, and ``alive``) until none is alive. Each
    CHECK_EVERY steps the host reads the live rays, writes every ray's
    ``outputs`` keys (out[key][idx] = state[key]) and keeps only the live
    rays."""
    stats["queries"] += 1
    while True:
        stats["syncs"] += 1
        keep = state["alive"].nonzero()[:, 0]
        for key, out in outputs.items():
            out[state["idx"]] = state[key]
        if keep.numel() == 0:
            return
        state = {k: v[keep] for k, v in state.items()}
        for _ in range(CHECK_EVERY):
            step(state)
            stats["iterations"] += 1


def _rays_state(rays: Rays, dead):
    o = rays.origin.detach().contiguous()
    d = rays.direction.detach().contiguous()
    R = o.shape[0]
    idx = torch.arange(R, device=o.device)
    alive = (torch.ones(R, dtype=torch.bool, device=o.device) if dead is None
             else ~dead)
    return o, d, idx, alive


# ---------------------------------------------------------------------------
# BVH walk


def _aabb_enter(bmin, bmax, o, inv_d):
    """AABB::intercepts (boundingBox.cpp:64-124): hit flag and entry t
    (the exit t when the entry is behind the origin)."""
    lo = (bmin - o) * inv_d
    hi = (bmax - o) * inv_d
    pos = inv_d >= 0.0
    t0 = torch.where(pos, lo, hi).amax(dim=-1)
    t1 = torch.where(pos, hi, lo).amin(dim=-1)
    return (t0 < t1) & (t1 > 0.0), torch.where(t0 < 0.0, t1, t0)


def _is_inside(bmin, bmax, p):
    """AABB::isInside (boundingBox.cpp:41-44), strict inequalities."""
    return ((p > bmin) & (p < bmax)).all(dim=-1)


def _bvh_walk(bvh: BvhArrays, prims: Primitives, rays: Rays, dead,
              any_hit_max_t=None):
    """(t [R], id [R]) of the tree's closest hit; with ``any_hit_max_t``
    each walk stops at its first hit before it."""
    o, d, idx, alive = _rays_state(rays, dead)
    R, dev = o.shape[0], o.device
    inv = _safe_inv(d)
    root_hit, _ = _aabb_enter(bvh.bbox_min[0], bvh.bbox_max[0], o, inv)
    out = {"tb": torch.full((R,), C.BIG, dtype=o.dtype, device=dev),
           "ib": torch.full((R,), -1, dtype=torch.int64, device=dev)}
    state = dict(
        idx=idx, o=o, d=d, inv=inv, alive=alive & root_hit,
        cur=torch.zeros(R, dtype=torch.int64, device=dev),  # -1: pop next
        sp=torch.zeros(R, dtype=torch.int64, device=dev),
        sn=torch.zeros((R, STACK), dtype=torch.int64, device=dev),
        st=torch.zeros((R, STACK), dtype=o.dtype, device=dev),
        tb=out["tb"].clone(), ib=out["ib"].clone())
    k = torch.arange(LEAF_MAX, device=dev)
    n_order = bvh.order.shape[0]
    n_nodes = bvh.leaf.shape[0]

    def step(s):
        o, d, inv, tb = s["o"], s["d"], s["inv"], s["tb"]
        at = s["alive"] & (s["cur"] >= 0)
        c = s["cur"].clamp(min=0)
        is_leaf = bvh.leaf[c]
        index = bvh.index[c].long()

        # a leaf: test its objects, in order
        count = torch.where(at & is_leaf, bvh.n_objs[c], 0)
        in_range = k[None, :] < count[:, None]
        oids = torch.where(
            in_range,
            bvh.order[(index[:, None] + k).clamp(max=n_order - 1)].long(), -1)
        lt, lid = _first_min(_pair_t(prims, oids, o, d), oids)
        better = lt < tb
        tb = torch.where(better, lt, tb)
        s["tb"] = tb
        s["ib"] = torch.where(better, lid, s["ib"])

        # an inner node: test both children, descend the nearer, push the
        # farther
        internal = at & ~is_leaf
        li = torch.where(internal, index, 0)
        ri = (li + 1).clamp(max=n_nodes - 1)
        lmin, lmax = bvh.bbox_min[li], bvh.bbox_max[li]
        rmin, rmax = bvh.bbox_min[ri], bvh.bbox_max[ri]
        lhit, ldist = _aabb_enter(lmin, lmax, o, inv)
        rhit, rdist = _aabb_enter(rmin, rmax, o, inv)
        ldist = torch.where(_is_inside(lmin, lmax, o), 0.0, ldist)
        rdist = torch.where(_is_inside(rmin, rmax, o), 0.0, rdist)
        # prune against the current closest (bvh.cpp:296-300)
        lhit = lhit & (ldist <= tb)
        rhit = rhit & (rdist <= tb)
        both = internal & lhit & rhit
        left_first = ldist < rdist
        near = torch.where(left_first, li, ri)
        far = torch.where(left_first, ri, li)
        far_t = torch.where(left_first, rdist, ldist)
        one = internal & (lhit ^ rhit)
        nxt = torch.where(both, near,
                          torch.where(one, torch.where(lhit, li, ri), -1))
        top = s["sp"].clamp(max=STACK - 1)[:, None]
        s["sn"].scatter_(1, top, torch.where(
            both, far, s["sn"].gather(1, top)[:, 0])[:, None])
        s["st"].scatter_(1, top, torch.where(
            both, far_t, s["st"].gather(1, top)[:, 0])[:, None])
        sp = s["sp"] + both.long()
        cur = torch.where(at, nxt, s["cur"])

        # a ray with no child to descend pops: the first entry nearer than
        # the closest hit (one entry a step)
        pop = s["alive"] & (cur < 0)
        alive = s["alive"] & ~(pop & (sp == 0))
        can = pop & (sp > 0)
        sp = sp - can.long()
        top = sp.clamp(min=0)[:, None]
        ok = can & (s["st"].gather(1, top)[:, 0] < tb)
        s["cur"] = torch.where(ok, s["sn"].gather(1, top)[:, 0], cur)
        s["sp"] = sp
        if any_hit_max_t is not None:
            alive = alive & ~(tb < any_hit_max_t)
        s["alive"] = alive

    _run(state, step, out)
    return out["tb"], out["ib"]


@torch.no_grad()
def bvh_closest_plain(bvh: BvhArrays, prims: Primitives, rays: Rays,
                      dead=None):
    """Closest hit through the median BVH and the planes beside it: (t [R],
    obj_id [R] int32), -1 on a miss."""
    t_tree, id_tree = _bvh_walk(bvh, prims, rays, dead)
    t_unb, id_unb = _unbounded_closest(prims, bvh.unbounded_ids,
                                       rays.origin, rays.direction)
    return _merge(t_tree, id_tree, t_unb, id_unb, dead)


@torch.no_grad()
def bvh_any_plain(bvh: BvhArrays, prims: Primitives, rays: Rays, max_t,
                  dead=None):
    """Occlusion [R] bool of segments ``rays`` (t < max_t): the walk stops
    at its first hit before ``max_t`` (BVH::Traverse(Ray&),
    bvh.cpp:348-416); the planes are tested beside it."""
    t_tree, _ = _bvh_walk(bvh, prims, rays, dead, any_hit_max_t=max_t)
    t_unb, _ = _unbounded_closest(prims, bvh.unbounded_ids, rays.origin,
                                  rays.direction)
    return _occluded(t_tree < max_t, t_unb, max_t, dead)


def _merge(t_acc, id_acc, t_unb, id_unb, dead):
    use_unb = t_unb < t_acc
    t = torch.where(use_unb, t_unb, t_acc)
    oid = torch.where(use_unb, id_unb, id_acc)
    if dead is not None:
        t = torch.where(dead, C.BIG, t)
    return t, torch.where(t >= C.BIG, -1, oid).to(torch.int32)


def _occluded(occ, t_unb, max_t, dead):
    occ = occ | (t_unb < max_t)
    return occ if dead is None else occ | dead


# ---------------------------------------------------------------------------
# uniform grid DDA


def _grid_setup(grid: GridArrays, o, d):
    """The DDA's start (grid.cpp:101-180): (misses the grid, first cell
    [n, 3], t of the next cell boundary a axis, its step in t, the cell
    step and the index that ends the walk a axis)."""
    n_vec = torch.tensor([grid.nx, grid.ny, grid.nz], dtype=torch.int64,
                         device=o.device)
    n_f = n_vec.to(o.dtype)
    b0, b1 = grid.bbox_min, grid.bbox_max
    inv = _safe_inv(d)
    lo = (b0 - o) * inv
    hi = (b1 - o) * inv
    pos = inv >= 0.0
    tmin = torch.where(pos, lo, hi)
    tmax = torch.where(pos, hi, lo)
    t0 = tmin.amax(dim=-1)
    t1 = tmax.amin(dim=-1)
    misses = (t0 > t1) | (t1 < 0.0)
    inside = _is_inside(b0, b1, o)
    entry = torch.where(inside[:, None], o, o + d * t0[:, None])
    cell = ((entry - b0) * n_f / (b1 - b0)).to(torch.int32).long()
    cell = torch.minimum(cell.clamp(min=0), n_vec - 1)
    dt = (tmax - tmin) / n_f
    fwd = d > 0
    step = torch.where(fwd, 1, -1)
    stop = torch.where(fwd, n_vec, -1)
    t_next = torch.where(fwd, tmin + (cell + 1).to(o.dtype) * dt,
                         tmin + (n_f - cell.to(o.dtype)) * dt)
    t_next = torch.where(d == 0.0, C.BIG, t_next)
    return misses, cell, t_next, dt, step, stop, n_vec


def _grid_walk(grid: GridArrays, prims: Primitives, rays: Rays, dead,
               max_t=None):
    """Closest hit (t, id) of the grid's objects (Grid::Traverse,
    grid.cpp:101-310); with ``max_t`` the shadow DDA (grid.cpp:313-361):
    (occluded, the grid entry failed)."""
    o, d, idx, alive = _rays_state(rays, dead)
    R, dev = o.shape[0], o.device
    misses, cell, t_next, dt, step, stop, n_vec = _grid_setup(grid, o, d)
    shadow = max_t is not None
    if shadow:
        out = {"occ": torch.zeros(R, dtype=torch.bool, device=dev)}
    else:
        out = {"tb": torch.full((R,), C.BIG, dtype=o.dtype, device=dev),
               "ib": torch.full((R,), -1, dtype=torch.int64, device=dev)}
    state = dict(idx=idx, o=o, d=d, cell=cell, t_next=t_next, dt=dt,
                 step=step, stop=stop, alive=alive & ~misses,
                 **{k: v.clone() for k, v in out.items()})
    nx, ny = grid.nx, grid.ny

    def step_fn(s):
        o, d, alive = s["o"], s["d"], s["alive"]
        cell = torch.minimum(s["cell"].clamp(min=0), n_vec - 1)
        flat = cell[:, 0] + nx * (cell[:, 1] + ny * cell[:, 2])
        items = grid.cell_items[flat].long()
        t = _pair_t(prims, items, o, d)
        t_exit, axis = s["t_next"].min(dim=1)
        if shadow:
            hit = (t < max_t).any(dim=1)
            s["occ"] = s["occ"] | (alive & hit)
        else:
            ct, cid = _first_min(t, items)
            # accept only a hit inside this cell's slab
            hit = ct < t_exit
            take = alive & hit
            s["tb"] = torch.where(take, ct, s["tb"])
            s["ib"] = torch.where(take, cid, s["ib"])
        ax = axis[:, None]
        s["cell"] = s["cell"].scatter_add(1, ax, s["step"].gather(1, ax))
        s["t_next"] = s["t_next"].scatter_add(1, ax, s["dt"].gather(1, ax))
        out_of_grid = (s["cell"].gather(1, ax) == s["stop"].gather(1, ax)
                       )[:, 0]
        s["alive"] = alive & ~hit & ~out_of_grid

    _run(state, step_fn, out)
    if shadow:
        return out["occ"], misses
    return out["tb"], out["ib"]


@torch.no_grad()
def grid_closest_plain(grid: GridArrays, prims: Primitives, rays: Rays,
                       dead=None):
    """Closest hit through the grid DDA and the planes beside it: (t [R],
    obj_id [R] int32), -1 on a miss."""
    t_g, id_g = _grid_walk(grid, prims, rays, dead)
    t_unb, id_unb = _unbounded_closest(prims, grid.unbounded_ids,
                                       rays.origin, rays.direction)
    return _merge(t_g, id_g, t_unb, id_unb, dead)


@torch.no_grad()
def grid_any_plain(grid: GridArrays, prims: Primitives, rays: Rays, max_t,
                   dead=None, init_fail_occludes: bool = False):
    """Occlusion [R] bool through the shadow DDA and the planes.
    ``init_fail_occludes=True`` is the reference's grid.cpp:326-328 quirk:
    a ray whose grid entry fails is occluded
    (RenderConfig.reference_grid_shadow_initfail)."""
    occ, init_fail = _grid_walk(grid, prims, rays, dead, max_t)
    if init_fail_occludes:
        occ = occ | init_fail
    t_unb, _ = _unbounded_closest(prims, grid.unbounded_ids, rays.origin,
                                  rays.direction)
    return _occluded(occ, t_unb, max_t, dead)


# ---------------------------------------------------------------------------
# dispatch: the plain version on CPU tensors, the kernels on CUDA tensors


def _kernel_args(rays: Rays, dead):
    return (rays.origin.detach().contiguous(),
            rays.direction.detach().contiguous(),
            None if dead is None else dead.contiguous())


def bvh_closest_hit(bvh: BvhArrays, prims: Primitives, rays: Rays,
                    dead=None):
    """Closest hit through the median BVH and the planes beside it: (t [R],
    obj_id [R] int32), -1 on a miss; ``dead`` slots read (BIG, -1)."""
    if rays.origin.device.type == "cpu":
        return bvh_closest_plain(bvh, prims, rays, dead)
    from ..kernels import perray_bvh_closest

    return perray_bvh_closest(bvh, prims, *_kernel_args(rays, dead))


def bvh_any_hit(bvh: BvhArrays, prims: Primitives, rays: Rays, max_t,
                dead=None):
    """Occlusion [R] bool of segments ``rays`` (t < max_t) through the
    median BVH, whose walk stops at its first hit before ``max_t``
    (BVH::Traverse(Ray&), bvh.cpp:348-416), and the planes; ``dead`` slots
    read occluded."""
    if rays.origin.device.type == "cpu":
        return bvh_any_plain(bvh, prims, rays, max_t, dead)
    from ..kernels import perray_bvh_any

    o, d, dead = _kernel_args(rays, dead)
    return perray_bvh_any(bvh, prims, o, d, float(max_t), dead)


def grid_closest_hit(grid: GridArrays, prims: Primitives, rays: Rays,
                     dead=None):
    """Closest hit through the grid DDA and the planes beside it: (t [R],
    obj_id [R] int32), -1 on a miss; ``dead`` slots read (BIG, -1)."""
    if rays.origin.device.type == "cpu":
        return grid_closest_plain(grid, prims, rays, dead)
    from ..kernels import grid_closest

    return grid_closest(grid, prims, *_kernel_args(rays, dead))


def grid_any_hit(grid: GridArrays, prims: Primitives, rays: Rays, max_t,
                 dead=None, init_fail_occludes: bool = False):
    """Occlusion [R] bool through the shadow DDA and the planes.
    ``init_fail_occludes=True`` is the reference's grid.cpp:326-328 quirk:
    a ray whose grid entry fails is occluded
    (RenderConfig.reference_grid_shadow_initfail)."""
    if rays.origin.device.type == "cpu":
        return grid_any_plain(grid, prims, rays, max_t, dead,
                              init_fail_occludes)
    from ..kernels import grid_any

    o, d, dead = _kernel_args(rays, dead)
    return grid_any(grid, prims, o, d, float(max_t), dead,
                    init_fail_occludes)
