"""Ray/primitive intersection over the type-grouped SoA tables: the
counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/ops/intersect.py``
without its matrix-unit branches. Its Pallas brute-force kernels (K4a-K4e)
are ``csrc/brute_intersect.cu``, launched on CUDA tensors by
``closest_hit_brute``/``any_hit_brute``; ``closest_hit_plain``/
``any_hit_plain`` are their plain version.

Reference semantics reproduced exactly (f32, EPSILON=1e-3):
  sphere  — quadratic in the direct (o−c) form, smaller root ≥ 0 (scene.cpp:149-172)
  triangle— Möller–Trumbore with det cutoff                     (scene.cpp:55-88)
  plane   — denom cutoff, t>0                                   (scene.cpp:119-142)
  aaBox   — slab test, entry-or-exit t                          (scene.cpp:198-278)

Each ``_*_t_one`` form takes primitive parameters and ray components as
columns that broadcast: scalars against [R] rays (the small-scene path and
the per-ray re-intersection), or [1, K] rows against [R, 1] rays (the typed
[R, K] path of larger scenes). Closest-hit ties keep the reference's strict
``<``: the lowest index wins within a type, and across types the order is
tri, sphere, plane, box (JAX ``ops/intersect.py:363-367``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import constants as C
from ..core.types import Primitives, Rays, normalize

_EPS = C.EPSILON

# Up to this many primitives in all, closest and any hit loop over the
# primitives one by one on [R] vectors; above it they run [R, chunk] blocks.
SMALL_UNROLL_MAX = 48


def _cols3(a):
    return a[..., 0], a[..., 1], a[..., 2]


def _sphere_t_one(p, o_cols, d_cols):
    """Sphere t in the reference's direct (o−c) form; BIG on miss."""
    ox, oy, oz = o_cols
    dx, dy, dz = d_cols
    a = dx * dx + dy * dy + dz * dz
    lx = ox - p[0]
    ly = oy - p[1]
    lz = oz - p[2]
    b = 2.0 * (dx * lx + dy * ly + dz * lz)
    cc = lx * lx + ly * ly + lz * lz - p[3] * p[3]
    delta = b * b - 4.0 * a * cc
    pos = delta > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, delta, 1.0)), 0.0)
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    t = torch.where(lo < 0.0, hi, lo)
    ok = (delta >= 0.0) & (t >= 0.0)
    return torch.where(ok, t, C.BIG)


def _triangle_t_one(p, o_cols, d_cols):
    ox, oy, oz = o_cols
    dx, dy, dz = d_cols
    v0x, v0y, v0z = p[0], p[1], p[2]
    e1x, e1y, e1z = p[3], p[4], p[5]
    e2x, e2y, e2z = p[6], p[7], p[8]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    ok = det.abs() > _EPS
    f = 1.0 / torch.where(ok, det, 1.0)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ok & (t > _EPS)
    return torch.where(ok, t, C.BIG)


def _plane_t_one(p, o_cols, d_cols):
    ox, oy, oz = o_cols
    dx, dy, dz = d_cols
    denom = dx * p[0] + dy * p[1] + dz * p[2]
    ok = denom.abs() > _EPS
    t = -(ox * p[0] + oy * p[1] + oz * p[2] + p[3]) / torch.where(ok, denom,
                                                                  1.0)
    ok = ok & (t > 0.0)
    return torch.where(ok, t, C.BIG)


def _box_t_one(p, o_cols, d_cols, inv_cols):
    t_in = t_out = None
    for ax in range(3):
        inv = inv_cols[ax]
        lo = (p[ax] - o_cols[ax]) * inv
        hi = (p[3 + ax] - o_cols[ax]) * inv
        pos = inv >= 0.0
        tmin = torch.where(pos, lo, hi)
        tmax = torch.where(pos, hi, lo)
        t_in = tmin if t_in is None else torch.maximum(t_in, tmin)
        t_out = tmax if t_out is None else torch.minimum(t_out, tmax)
    ok = (t_in < t_out) & (t_out > _EPS)
    t = torch.where(t_in > _EPS, t_in, t_out)
    return torch.where(ok, t, C.BIG)


def _safe_inv(d):
    """1/d with zero components mapped to ±1e30 instead of inf: the slab
    semantics of the reference's IEEE-inf arithmetic (scene.cpp:203),
    NaN-free."""
    tiny = d.abs() < 1e-30
    sign = torch.where(d < 0.0, -1.0, 1.0)
    return torch.where(tiny, sign * 1e30, 1.0 / torch.where(tiny, 1.0, d))


def _prim_t(code, p, o_cols, d_cols, inv_cols):
    if code == C.TRIANGLE:
        return _triangle_t_one(p, o_cols, d_cols)
    if code == C.SPHERE:
        return _sphere_t_one(p, o_cols, d_cols)
    if code == C.PLANE:
        return _plane_t_one(p, o_cols, d_cols)
    return _box_t_one(p, o_cols, d_cols, inv_cols)


def _type_tables(prims: Primitives):
    """(type code, table, ids, count) in the cross-type tie order."""
    return [(C.TRIANGLE, prims.tri_p, prims.tri_ids, prims.n_tri),
            (C.SPHERE, prims.sph_p, prims.sph_ids, prims.n_sph),
            (C.PLANE, prims.pl_p, prims.pl_ids, prims.n_pl),
            (C.AABOX, prims.box_p, prims.box_ids, prims.n_box)]


def _small_total(prims: Primitives) -> int:
    return prims.n_tri + prims.n_sph + prims.n_pl + prims.n_box


# ---------------------------------------------------------------------------
# small scenes: one [R] test per primitive


def _small_sweeps(prims: Primitives, o, d):
    """Yield (t [R], global id) per primitive in the tie order."""
    o_cols = _cols3(o)
    d_cols = _cols3(d)
    inv_cols = _cols3(_safe_inv(d)) if prims.n_box > 0 else None
    for code, table, ids, n in _type_tables(prims):
        for i in range(n):
            yield _prim_t(code, table[i], o_cols, d_cols, inv_cols), ids[i]


def _no_hit(o):
    """(t BIG, obj_id -1) for rays ``o`` [R, 3]: a closest hit's start."""
    return (torch.full(o.shape[:1], C.BIG, dtype=o.dtype, device=o.device),
            torch.full(o.shape[:1], -1, dtype=torch.int32, device=o.device))


def _no_occluder(o, dead=None):
    """An any hit's start for rays ``o`` [R, 3]: only the ``dead`` lanes
    [R] bool, which the caller masks downstream, count as occluded."""
    if dead is not None:
        return dead.clone()
    return torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)


def _small_closest(prims: Primitives, rays: Rays):
    o = rays.origin
    t_best, id_best = _no_hit(o)
    for t, gid in _small_sweeps(prims, o, rays.direction):
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        id_best = torch.where(better, gid, id_best)
    return t_best, torch.where(t_best >= C.BIG, -1, id_best)


def _small_any(prims: Primitives, rays: Rays, max_t, dead=None):
    o = rays.origin
    occ = _no_occluder(o, dead)
    for t, _ in _small_sweeps(prims, o, rays.direction):
        occ = occ | (t < max_t)
    return occ


# ---------------------------------------------------------------------------
# larger scenes: [R, chunk] blocks per type


def _typed_blocks(code, table, ids, o, d, chunk):
    """Yield (t [R, c], ids [c]) over one type table, padding rows at BIG."""
    o_cols = tuple(o[:, k:k + 1] for k in range(3))
    d_cols = tuple(d[:, k:k + 1] for k in range(3))
    inv = _safe_inv(d) if code == C.AABOX else None
    inv_cols = (tuple(inv[:, k:k + 1] for k in range(3))
                if inv is not None else None)
    for s in range(0, table.shape[0], chunk):
        rows = table[s:s + chunk]
        idc = ids[s:s + chunk]
        p = [rows[:, k][None, :] for k in range(rows.shape[1])]
        t = _prim_t(code, p, o_cols, d_cols, inv_cols)
        yield torch.where(idc[None, :] >= 0, t, C.BIG), idc


def _fold_closest(prims: Primitives, codes, o, d, t_best, id_best, chunk):
    """Fold the types ``codes`` of ``prims`` into the running best (t, id)
    in [R, chunk] blocks; strict < keeps the earlier type on exact ties."""
    for code, table, ids, n in _type_tables(prims):
        if n == 0 or code not in codes:
            continue
        for t, idc in _typed_blocks(code, table, ids, o, d, chunk):
            # min, then the lowest id among exact-min lanes: the
            # reference's first-in-ascending-scan tie rule
            t_min = t.min(dim=-1).values
            pid = torch.where(t == t_min[:, None], idc[None, :],
                              2 ** 30).min(dim=-1).values
            better = t_min < t_best
            t_best = torch.where(better, t_min, t_best)
            id_best = torch.where(better, pid.to(torch.int32), id_best)
    return t_best, id_best


def _any_blocks(prims: Primitives, codes, o, d, max_t, occ, chunk):
    """OR the occlusion of the types ``codes`` into ``occ``, in [R, chunk]
    blocks."""
    for code, table, ids, n in _type_tables(prims):
        if n == 0 or code not in codes:
            continue
        for t, _ in _typed_blocks(code, table, ids, o, d, chunk):
            occ = occ | (t < max_t).any(dim=-1)
    return occ


_ALL_TYPES = (C.TRIANGLE, C.SPHERE, C.PLANE, C.AABOX)
_SWEPT_TYPES = (C.PLANE, C.AABOX)  # beside the kernels, as JAX sweeps them


def closest_hit_plain(prims: Primitives, rays: Rays, chunk: int = 2048):
    """Closest hit over every primitive in [R, chunk] blocks per type: the
    brute-force kernels' plain version (csrc/brute_intersect.cu).

    Returns (t [R], obj_id [R] int32); obj_id == -1 on miss.
    """
    o, d = rays.origin, rays.direction
    t_best, id_best = _fold_closest(prims, _ALL_TYPES, o, d, *_no_hit(o),
                                    chunk)
    return t_best, torch.where(t_best >= C.BIG, -1, id_best)


def any_hit_plain(prims: Primitives, rays: Rays, max_t, dead=None,
                  chunk: int = 2048) -> torch.Tensor:
    """Occlusion over every primitive in [R, chunk] blocks per type: the
    brute-force kernels' plain version. ``dead`` [R] bool lanes report
    occluded."""
    o, d = rays.origin, rays.direction
    return _any_blocks(prims, _ALL_TYPES, o, d, max_t, _no_occluder(o, dead),
                       chunk)


@dataclasses.dataclass(frozen=True)
class BruteTables:
    """The triangles and spheres of a scene as the brute-force kernels read
    them (csrc/brute_intersect.cu), padding rows dropped. Rows are 16-byte
    aligned float4s: a sphere (center, radius) with its id beside it in
    ``sph_ids``; a triangle (v0, e1, e2, id as int32 bits, 2 pad)."""

    sph: torch.Tensor      # [Ks, 4] f32
    sph_ids: torch.Tensor  # [Ks] int32 global object ids
    tri: torch.Tensor      # [Kt, 12] f32
    n_sph: int = 0
    n_tri: int = 0


def brute_tables(prims: Primitives) -> BruteTables:
    """Pack the kernels' tables from the type views of ``prims``."""
    sph = prims.sph_p[:prims.n_sph, :4].contiguous()
    sph_ids = prims.sph_ids[:prims.n_sph].to(torch.int32).contiguous()
    tri_p = prims.tri_p[:prims.n_tri]
    tri = tri_p.new_zeros((prims.n_tri, 12))
    tri[:, :9] = tri_p[:, :9]
    tri[:, 9] = prims.tri_ids[:prims.n_tri].to(torch.int32).view(
        torch.float32)
    return BruteTables(sph, sph_ids, tri, prims.n_sph, prims.n_tri)


def _kernel_tables(tables: BruteTables | None) -> BruteTables:
    if tables is None:
        raise ValueError("the brute-force kernels need the scene's packed "
                         "tables (Scene.brute) on CUDA tensors")
    return tables


def closest_hit_brute(prims: Primitives, rays: Rays,
                      tables: BruteTables | None = None):
    """Brute-force closest hit (accel NONE path, main.cpp:542-553).

    Up to SMALL_UNROLL_MAX primitives, one [R] test per primitive on any
    device. Above it, CPU tensors run the plain version and CUDA tensors
    one launch of the kernel over the triangles and spheres
    (``kernels.brute_closest`` on ``tables``, the scene's ``Scene.brute``),
    with planes and boxes folded after it in PyTorch. Returns (t [R],
    obj_id [R] int32); obj_id == -1 on miss.
    """
    if 0 < _small_total(prims) <= SMALL_UNROLL_MAX:
        return _small_closest(prims, rays)
    if rays.origin.device.type == "cpu":
        return closest_hit_plain(prims, rays)
    o = rays.origin.contiguous()
    d = rays.direction.contiguous()
    if prims.n_tri + prims.n_sph:
        from ..kernels import brute_closest

        t_best, id_best = brute_closest(_kernel_tables(tables), o, d)
    else:
        t_best, id_best = _no_hit(o)
    t_best, id_best = _fold_closest(prims, _SWEPT_TYPES, o, d, t_best,
                                    id_best, 2048)
    return t_best, torch.where(t_best >= C.BIG, -1, id_best)


def any_hit_brute(prims: Primitives, rays: Rays, max_t, dead=None,
                  tables: BruteTables | None = None) -> torch.Tensor:
    """Shadow-ray occlusion: any hit with t < max_t (main.cpp:481-509).

    Pass max_t = BIG for the reference's unbounded NONE-mode semantics, or
    1.0 with unnormalized light vectors for the physical bound. ``dead`` [R]
    bool marks lanes the caller masks downstream: they report occluded
    without a test. Dispatch as ``closest_hit_brute``
    (``kernels.brute_any`` on CUDA tensors).
    """
    if 0 < _small_total(prims) <= SMALL_UNROLL_MAX:
        return _small_any(prims, rays, max_t, dead)
    if rays.origin.device.type == "cpu":
        return any_hit_plain(prims, rays, max_t, dead)
    o = rays.origin.contiguous()
    d = rays.direction.contiguous()
    if prims.n_tri + prims.n_sph:
        from ..kernels import brute_any

        occ = brute_any(_kernel_tables(tables), o, d, float(max_t),
                        None if dead is None else dead.contiguous())
    else:
        occ = _no_occluder(o, dead)
    return _any_blocks(prims, _SWEPT_TYPES, o, d, max_t, occ, 2048)


# ---------------------------------------------------------------------------
# shade-time re-intersection of the chosen primitive


def gather_prims(prims: Primitives, obj_id: torch.Tensor):
    """(params [R,12], ptype [R], mat_id [R]) of each ray's primitive;
    ptype is INVALID where obj_id < 0."""
    safe = obj_id.clamp(min=0).long()
    params = prims.params[safe]
    ptype = torch.where(obj_id < 0, C.INVALID, prims.ptype[safe])
    return params, ptype, prims.mat_id[safe]


def per_ray_t(params, ptype, o, d, present=(True, True, True, True)):
    """t for each ray against its own gathered primitive params: [R].
    ``present`` = (sphere, triangle, plane, box) statically prunes absent
    types."""
    has_sph, has_tri, has_pl, has_box = present
    o_cols = _cols3(o)
    d_cols = _cols3(d)
    pc = [params[:, i] for i in range(12)]
    inv_cols = _cols3(_safe_inv(d)) if has_box else None
    t = torch.full(o.shape[:1], C.BIG, dtype=o.dtype, device=o.device)
    for code, has in ((C.TRIANGLE, has_tri), (C.SPHERE, has_sph),
                      (C.PLANE, has_pl), (C.AABOX, has_box)):
        if has:
            t = torch.where(ptype == code,
                            _prim_t(code, pc, o_cols, d_cols, inv_cols), t)
    return t


def per_ray_normal(params, ptype, point, o, d,
                   present=(True, True, True, True)):
    """Geometric normal at ``point`` for each ray's gathered primitive.

    sphere: (p-c)/|p-c| (scene.cpp:174-178); triangle: stored flat normal
    (scene.cpp:46-49); plane: PN (scene.cpp:144-147); aaBox: entry/exit face
    normal from the slab test (scene.cpp:234-276).
    """
    has_sph, has_tri, has_pl, has_box = present
    n = torch.zeros_like(point)
    if has_tri:
        n = torch.where((ptype == C.TRIANGLE)[:, None], params[:, 9:12], n)
    if has_sph:
        n = torch.where((ptype == C.SPHERE)[:, None],
                        normalize(point - params[:, 0:3]), n)
    if has_pl:
        n = torch.where((ptype == C.PLANE)[:, None], params[:, 0:3], n)
    if has_box:
        inv = _safe_inv(d)
        lo = (params[:, 0:3] - o) * inv
        hi = (params[:, 3:6] - o) * inv
        pos = inv >= 0.0
        tmin = torch.where(pos, lo, hi)
        tmax = torch.where(pos, hi, lo)
        ax_in = tmin.argmax(dim=-1)
        ax_out = tmax.argmin(dim=-1)
        t_in = tmin.max(dim=-1).values
        # reference sign convention: -1 if the slab t is negative else +1
        s_in = torch.where(tmin.gather(-1, ax_in[:, None])[:, 0] < 0, -1.0,
                           1.0)
        s_out = torch.where(tmax.gather(-1, ax_out[:, None])[:, 0] < 0, -1.0,
                            1.0)
        use_in = t_in > _EPS
        ax = torch.where(use_in, ax_in, ax_out)
        sgn = torch.where(use_in, s_in, s_out)
        n_box = torch.nn.functional.one_hot(ax, 3).to(point.dtype) * sgn[:, None]
        n = torch.where((ptype == C.AABOX)[:, None], n_box, n)
    return n
