"""The plain Whitted frame and the light fit's step: plain PyTorch over the
benchmark's scene description, brute-force intersection in blocks.

A frozen copy of the port's plain sweep (the level sweep of its
``models/whitted.py`` over ``ops/intersect.py``'s brute-force blocks and
``ops/shade.py``), cut to what the benchmark's scenes use: triangles and
spheres, point lights, hard shadows bounded at the light (``max_t`` 1 on
the unnormalised light vector), Schlick's Fresnel weight, the reference's
refraction direction, no anti-aliasing. Each operation is the port's, in
its order, so on the card the reference rounds as the program's plain
version does, and on the same device its camera and rays are the
program's bit for bit.

``build`` makes the tables from the description in any float ``dtype``:
float32 is the reference, bfloat16 the control that stands in for a
program computed one precision lower. ``render`` gives a frame, and with
``stats`` it also counts the work that the benchmark's roofline bounds
charge (``portbench/work``): the live rays of every query and, for brute
force, each ray-primitive test by where it ended. ``light_steps`` runs the
light fit's train steps with plain autograd.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..scenes import SPHERE, TRIANGLE, Description

EPS = 1e-3
BIG = 1e30
# elements of one [rays, rows] block of the brute-force tests
BLOCK = 1 << 24
CHUNK = 2048   # table rows a block, as the port's plain version


@dataclasses.dataclass
class Scene:
    params: torch.Tensor    # [N, 12]: triangle v0, e1, e2, normal; sphere c, r
    ptype: torch.Tensor     # [N] int32, TRIANGLE or SPHERE
    mat_id: torch.Tensor    # [N] int64
    tri: torch.Tensor       # [Kt, 12], the triangles in object order
    tri_ids: torch.Tensor   # [Kt] int32
    sph: torch.Tensor       # [Ks, 4]
    sph_ids: torch.Tensor   # [Ks] int32
    materials: dict         # name -> [M] or [M, 3]
    light_pos: torch.Tensor  # [L, 3]
    light_col: torch.Tensor  # [L, 3]
    bg: torch.Tensor        # [3]
    camera: dict            # eye, u, v, n [3]; w, h, plane_dist []; res_x, res_y
    reflective: bool
    transmissive: bool

    @property
    def n_objects(self) -> int:
        return self.params.shape[0]


MAT_FIELDS = ("diff_color", "kd", "spec_color", "ks", "shine", "transmit",
              "ior")
MAT_COLS = (slice(0, 3), 3, slice(4, 7), 7, 8, 9, 10)


def params_of(desc: Description) -> np.ndarray:
    """[N, 12] f32 rows of the objects: a triangle's v0, edges and unit
    flat normal (the Triangle ctor, scene.cpp:10-40), a sphere's centre and
    radius."""
    out = np.zeros((len(desc.kind), 12), np.float32)
    for i, (kind, row) in enumerate(zip(desc.kind, desc.data)):
        if kind == SPHERE:
            out[i, :4] = row[:4]
            continue
        p0 = np.asarray(row[0:3], np.float32)
        e1 = np.asarray(row[3:6], np.float32) - p0
        e2 = np.asarray(row[6:9], np.float32) - p0
        n = np.cross(e1, e2)
        ln = np.linalg.norm(n)
        if ln > 0:
            n = n / ln
        out[i] = np.concatenate([p0, e1, e2, n]).astype(np.float32)
    return out


def camera_of(cam: dict, device, dtype) -> dict:
    """The uvn frame of the camera ctor (camera.h:35-73), computed in f32
    on the host as the port computes it."""
    eye = np.asarray(cam["eye"], np.float32)
    at = np.asarray(cam["at"], np.float32)
    up = np.asarray(cam["up"], np.float32)
    n = eye - at
    plane_dist = float(np.linalg.norm(n))
    n = n / plane_dist
    u = np.cross(up, n)
    u = u / np.linalg.norm(u)
    v = np.cross(n, u)
    h = 2.0 * plane_dist * math.tan(math.pi * cam["fov"] / 180.0 / 2.0)
    w = (cam["res_x"] / cam["res_y"]) * h

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device).to(dtype)

    return dict(eye=t(eye), u=t(u), v=t(v), n=t(n), w=t(w), h=t(h),
                plane_dist=t(plane_dist), res_x=int(cam["res_x"]),
                res_y=int(cam["res_y"]))


def build(desc: Description, device, dtype=torch.float32) -> Scene:
    params = params_of(desc)
    kind = np.asarray(desc.kind, np.int32)
    mats = np.stack(desc.materials).astype(np.float32)
    lights = np.stack(desc.lights).astype(np.float32)

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device).to(dt)

    tri_ids = np.nonzero(kind == TRIANGLE)[0].astype(np.int32)
    sph_ids = np.nonzero(kind == SPHERE)[0].astype(np.int32)
    return Scene(
        params=t(params), ptype=t(kind, torch.int32),
        mat_id=t(np.asarray(desc.mat, np.int64), torch.int64),
        tri=t(params[tri_ids]), tri_ids=t(tri_ids, torch.int32),
        sph=t(params[sph_ids, :4]), sph_ids=t(sph_ids, torch.int32),
        materials={f: t(mats[:, c]) for f, c in zip(MAT_FIELDS, MAT_COLS)},
        light_pos=t(lights[:, 0:3]), light_col=t(lights[:, 3:6]),
        bg=t(desc.bg), camera=camera_of(desc.camera, device, dtype),
        reflective=bool((mats[:, 7] > 0).any()),
        transmissive=bool((mats[:, 9] != 0).any()))


def with_eye(scene: Scene, eye: torch.Tensor) -> Scene:
    """The camera moved to ``eye`` [3], its frame re-derived about the
    point it looks at, the old v as up (Camera::SetEye, camera.h:80-89)."""
    cam = scene.camera
    eye = eye.to(cam["eye"].dtype)
    at = cam["eye"] - cam["n"] * cam["plane_dist"]
    up = cam["v"]
    n = eye - at
    plane_dist = torch.linalg.vector_norm(n)
    n = n / plane_dist
    u = torch.linalg.cross(up, n)
    u = u / torch.linalg.vector_norm(u)
    v = torch.linalg.cross(n, u)
    return dataclasses.replace(scene, camera=dict(
        cam, eye=eye, u=u, v=v, n=n, plane_dist=plane_dist))


def with_light(scene: Scene, pos: torch.Tensor) -> Scene:
    return dataclasses.replace(scene, light_pos=pos)


# ---------------------------------------------------------------------------
# vector helpers and the primitive tests


def dot(a, b):
    return (a * b).sum(-1)


def normalize(a):
    n2 = (a * a).sum(-1, keepdim=True)
    ok = n2 > 0.0
    return torch.where(ok, a / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)


def sphere_parts(p, o, d):
    """(discriminant, t) of the sphere test in the direct (o - c) form
    (scene.cpp:149-172), t BIG on a miss."""
    ox, oy, oz = o
    dx, dy, dz = d
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
    return delta, torch.where(ok, t, BIG)


def triangle_parts(p, o, d):
    """(passed the det gate, the u gate, the v gate, t) of Möller-Trumbore
    with the det cutoff (scene.cpp:55-88), t BIG on a miss."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = p[0], p[1], p[2]
    e1x, e1y, e1z = p[3], p[4], p[5]
    e2x, e2y, e2z = p[6], p[7], p[8]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    ok_det = det.abs() > EPS
    f = 1.0 / torch.where(ok_det, det, 1.0)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    ok_u = ok_det & (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    ok_v = ok_u & (v >= 0.0) & (u + v <= 1.0)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ok_v & (t > EPS)
    return ok_det, ok_u, ok_v, torch.where(ok, t, BIG)


def _tables(scene: Scene):
    """(code, rows, ids) in the cross-type tie order: triangles, spheres."""
    return ((TRIANGLE, scene.tri, scene.tri_ids),
            (SPHERE, scene.sph, scene.sph_ids))


def _blocks(scene: Scene, o, d):
    """Yield (ray slice, code, t [b, c], stage [b, c], ids [c]) over blocks
    of rays and table rows: every live ray against every row, the stage
    where each test ended (a triangle's gates passed, 0-3; a sphere's
    discriminant >= 0, 0-1)."""
    rows_a_block = max((int(r.shape[0]) for _, r, _ in _tables(scene)),
                       default=1)
    step = max(1, BLOCK // max(1, min(CHUNK, rows_a_block)))
    for a in range(0, o.shape[0], step):
        sl = slice(a, a + step)
        oc = tuple(o[sl, k:k + 1] for k in range(3))
        dc = tuple(d[sl, k:k + 1] for k in range(3))
        for code, table, ids in _tables(scene):
            for s in range(0, table.shape[0], CHUNK):
                rows = table[s:s + CHUNK]
                p = [rows[:, k][None, :] for k in range(rows.shape[1])]
                if code == TRIANGLE:
                    ok_det, ok_u, ok_v, t = triangle_parts(p, oc, dc)
                    stage = ok_det.long() + ok_u.long() + ok_v.long()
                else:
                    delta, t = sphere_parts(p, oc, dc)
                    stage = (delta >= 0.0).long()
                yield sl, code, t, stage, ids[s:s + CHUNK]


def _count(stats, kind, live, stages, hits=0):
    if stats is not None:
        stats["queries"].append(dict(kind=kind, live=int(live),
                                     hits=int(hits), stages=stages.tolist()))


def _stage_counts(stages6, code, stage, tested=None):
    first, k = (0, 4) if code == TRIANGLE else (4, 2)
    sel = stage if tested is None else stage[tested]
    stages6[first:first + k] += torch.bincount(sel.reshape(-1), minlength=k)


@torch.no_grad()
def closest_hit(scene: Scene, o, d, dead, stats=None):
    """(t [R], id [R] int32) of the closest hit over every primitive; the
    ``dead`` [R] rays are not traced and read (BIG, -1). Ties keep the
    lowest id within a type and the earlier type across types."""
    live = ~dead
    lo, ld = o[live], d[live]
    t_best = torch.full(lo.shape[:1], BIG, dtype=o.dtype, device=o.device)
    id_best = torch.full(lo.shape[:1], -1, dtype=torch.int32, device=o.device)
    stages = torch.zeros(6, dtype=torch.int64, device=o.device)
    for sl, code, t, stage, idc in _blocks(scene, lo, ld):
        t_min = t.min(dim=-1).values
        pid = torch.where(t == t_min[:, None], idc[None, :],
                          2 ** 30).min(dim=-1).values
        better = t_min < t_best[sl]
        t_best[sl] = torch.where(better, t_min, t_best[sl])
        id_best[sl] = torch.where(better, pid.to(torch.int32), id_best[sl])
        if stats is not None:
            _stage_counts(stages, code, stage)
    id_best = torch.where(t_best >= BIG, -1, id_best)
    _count(stats, "closest", lo.shape[0], stages, (id_best >= 0).sum())
    t_out = torch.full(o.shape[:1], BIG, dtype=o.dtype, device=o.device)
    id_out = torch.full(o.shape[:1], -1, dtype=torch.int32, device=o.device)
    t_out[live], id_out[live] = t_best, id_best
    return t_out, id_out


@torch.no_grad()
def any_hit(scene: Scene, o, d, max_t, dead, stats=None):
    """Occlusion [R] bool by any primitive at t < ``max_t``; ``dead`` rays
    read occluded untested. With ``stats``, a ray's tests count in table
    order (triangles, then spheres) up to and including its first
    occluder."""
    live = ~dead
    lo, ld = o[live], d[live]
    occ = torch.zeros(lo.shape[:1], dtype=torch.bool, device=o.device)
    stages = torch.zeros(6, dtype=torch.int64, device=o.device)
    for sl, code, t, stage, _ in _blocks(scene, lo, ld):
        hits = t < max_t
        if stats is not None:
            before = hits.long().cumsum(dim=1) - hits.long()
            tested = ~occ[sl][:, None] & (before == 0)
            _stage_counts(stages, code, stage, tested)
        occ[sl] = occ[sl] | hits.any(dim=-1)
    _count(stats, "any", lo.shape[0], stages)
    out = dead.clone()
    out[live] = occ
    return out


# ---------------------------------------------------------------------------
# shading (processLight and the rayTracing body, main.cpp:471-721)


def blinn_phong(Lv, lit, light_color, mat, ray_dir, normal):
    Lh = normalize(Lv)
    V = normalize(-ray_dir)
    H = normalize(Lh + V)
    ndl = dot(normal, Lh).clamp(min=0.0)
    vdn = dot(H, normal).clamp(min=0.0)
    vdn_safe = torch.where(vdn > 0.0, vdn, 1.0)
    spec_pow = torch.where(vdn > 0.0, torch.pow(vdn_safe, mat["shine"]),
                           torch.where(mat["shine"] == 0.0, 1.0, 0.0))
    diff = light_color * mat["diff_color"] * ndl[:, None]
    spec = light_color * mat["spec_color"] * spec_pow[:, None]
    contrib = diff * mat["kd"][:, None] + spec * (mat["ks"] * 0.4)[:, None]
    return torch.where(lit[:, None], contrib, 0.0)


def refract(d, nf, inside, ior_1, mat_ior):
    """The reference's refraction direction t·sin(t) + n (main.cpp:671-697):
    (direction, can refract, cos i, new ior)."""
    V = -d
    ndv = dot(nf, V)
    viewtangent = nf * ndv[:, None] - V
    mat_ior = torch.where(mat_ior > 0.0, mat_ior, 1.0)
    eta = torch.where(inside, ior_1, ior_1 / mat_ior)
    cos_i = ndv.abs()
    vt2 = (viewtangent * viewtangent).sum(-1)
    sin_t = eta * torch.sqrt(vt2.clamp(min=1e-24))
    insqrt = 1.0 - sin_t * sin_t
    can = insqrt > 0.0
    t_hat = normalize(viewtangent)
    direction = t_hat * sin_t[:, None] + nf
    new_ior = torch.where(inside, 1.0, mat_ior)
    return direction, can, cos_i, new_ior


def fresnel_kr(can, cos_i, new_ior, ior_1, transmit, ks):
    """Schlick's weight, 1 on total internal reflection; Ks for opaque
    materials (main.cpp:699-717)."""
    r0 = ((ior_1 - new_ior) / (ior_1 + new_ior)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
    kr_t = torch.where(can, schlick, 1.0)
    return torch.where(transmit != 0.0, kr_t, ks)


def _direct(scene: Scene, ray_dir, hit_point, precise, normal, mat, hit,
            stats):
    color = torch.zeros_like(hit_point)
    for li in range(scene.light_pos.shape[0]):
        Lv = scene.light_pos[li][None, :] - hit_point
        facing = dot(Lv, normal) > 0.0
        occluded = any_hit(scene, precise.detach(), Lv.detach(), 1.0,
                           ~(hit & facing), stats)
        lit = hit & facing & ~occluded
        color = color + blinn_phong(Lv, lit, scene.light_col[li][None, :],
                                    mat, ray_dir, normal)
    return color


def _level(scene: Scene, o, d, active, ior_in, spawn: bool, stats):
    """One level of the sweep: trace, shade, and the children's rays."""
    t_disc, obj_id = closest_hit(scene, o.detach(), d.detach(), ~active,
                                 stats)
    hit = active & (obj_id >= 0)
    safe = obj_id.clamp(min=0).long()
    params = scene.params.index_select(0, safe)
    ptype = torch.where(obj_id < 0, -1, scene.ptype[safe])
    mat_id = scene.mat_id[safe]
    oc = (o[..., 0], o[..., 1], o[..., 2])
    dc = (d[..., 0], d[..., 1], d[..., 2])
    pc = [params[:, i] for i in range(12)]
    t = torch.full(o.shape[:1], BIG, dtype=o.dtype, device=o.device)
    if scene.tri.shape[0]:
        t = torch.where(ptype == TRIANGLE, triangle_parts(pc, oc, dc)[3], t)
    if scene.sph.shape[0]:
        t = torch.where(ptype == SPHERE, sphere_parts(pc, oc, dc)[1], t)
    t = torch.where(t >= BIG, t_disc, t)
    t = torch.where(hit, t, 1.0)
    hit_point = o + d * t[:, None]
    n = torch.zeros_like(hit_point)
    if scene.tri.shape[0]:
        n = torch.where((ptype == TRIANGLE)[:, None], params[:, 9:12], n)
    if scene.sph.shape[0]:
        n = torch.where((ptype == SPHERE)[:, None],
                        normalize(hit_point - params[:, 0:3]), n)
    normal = normalize(n)
    precise = hit_point + normal * EPS
    mat = {f: scene.materials[f].index_select(0, mat_id)
           for f in MAT_FIELDS}
    local = _direct(scene, d, hit_point, precise, normal, mat, hit, stats)
    miss = active & (obj_id < 0)
    bg = scene.bg[None, :].expand(local.shape)
    if not spawn:
        color = torch.where(hit[:, None], local.clamp(0.0, 1.0), 0.0)
        return torch.where(miss[:, None], bg, color), None
    inside = dot(d, normal) > 0.0
    nf = torch.where(inside[:, None], -normal, normal)
    refl_dir = normalize(d - 2.0 * nf * dot(d, nf)[:, None])
    refl_active = hit & (mat["ks"] > 0.0)
    r_dir, can, cos_i, new_ior = refract(d, nf, inside, ior_in, mat["ior"])
    refr_active = hit & (mat["transmit"] != 0.0) & can
    default = torch.zeros_like(r_dir)
    default[:, 2] = 1.0
    refr_dir = torch.where(refr_active[:, None], r_dir, default)
    refr_origin = torch.where(refr_active[:, None],
                              hit_point + refr_dir * 0.001, precise)
    kr = fresnel_kr(can, cos_i, new_ior, ior_in, mat["transmit"], mat["ks"])
    local_color = torch.where(hit[:, None], local, 0.0)
    local_color = torch.where(miss[:, None], bg, local_color)
    children = ((precise, refl_dir, refl_active, ior_in),
                (refr_origin, refr_dir, refr_active, new_ior))
    return local_color, (children, (kr, mat["spec_color"], hit))


def _interleave(a, b):
    return torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:]))


def trace(scene: Scene, o, d, max_depth: int, stats=None):
    """The colour [R, 3] of the whole recursion tree of each ray, clamped:
    level l holds R·2^l slots (2i the reflection, 2i+1 the refraction child
    of slot i), folded back with local + KR·spec·refl + (1 - KR)·refr."""
    R = o.shape[0]
    active = torch.ones(R, dtype=torch.bool, device=o.device)
    ior = torch.ones(R, dtype=o.dtype, device=o.device)
    if not (scene.reflective or scene.transmissive):
        return _level(scene, o, d, active, ior, True, stats)[0].clamp(0, 1)
    levels = []
    for lvl in range(max_depth):
        spawn = lvl < max_depth - 1
        color, nxt = _level(scene, o, d, active, ior, spawn, stats)
        if not spawn:
            break
        children, fold = nxt
        levels.append((color, fold))
        kids = [c for c, on in zip(children, (scene.reflective,
                                              scene.transmissive)) if on]
        if len(kids) == 2:
            o, d, active, ior = (_interleave(a, b)
                                 for a, b in zip(kids[0], kids[1]))
        else:
            o, d, active, ior = kids[0]
    child = color
    for local, (kr, spec, hit) in reversed(levels):
        if scene.reflective and scene.transmissive:
            refl, refr = child[0::2], child[1::2]
        elif scene.reflective:
            refl, refr = child, 0.0
        else:
            refl, refr = 0.0, child
        k = kr[:, None]
        combined = local + refl * k * spec + refr * (1.0 - k)
        child = torch.where(hit[:, None], combined, local)
    return child.clamp(0.0, 1.0)


def primary_rays(scene: Scene):
    """(o, d) [R, 3] of the pixel centres through the pinhole
    (camera.h:91-108), pixels row-major with row 0 at the bottom."""
    cam = scene.camera
    dev, dt = cam["eye"].device, cam["eye"].dtype
    ys, xs = torch.meshgrid(
        torch.arange(cam["res_y"], dtype=torch.float32, device=dev),
        torch.arange(cam["res_x"], dtype=torch.float32, device=dev),
        indexing="ij")
    px, py = xs.reshape(-1).to(dt) + 0.5, ys.reshape(-1).to(dt) + 0.5
    sx = cam["w"] * (px / cam["res_x"] - 0.5)
    sy = cam["h"] * (py / cam["res_y"] - 0.5)
    d = (sx[:, None] * cam["u"][None, :] + sy[:, None] * cam["v"][None, :]
         - cam["plane_dist"] * cam["n"][None, :])
    d = normalize(d)
    o = cam["eye"][None, :].expand(d.shape)
    return o, d


def render(scene: Scene, max_depth: int = 4, stats=None,
           pixels: slice | None = None) -> torch.Tensor:
    """The frame [res_y, res_x, 3] in [0, 1], row 0 the bottom scanline;
    with ``pixels``, only that slice of the flat pixel list, [n, 3].
    ``stats``: a dict that collects ``queries``, one a closest- or
    any-hit query: its kind, live rays, hits (of a closest hit) and the
    tests by where each ended (``portbench/work``'s stages)."""
    if stats is not None:
        stats.setdefault("queries", [])
    o, d = primary_rays(scene)
    if pixels is not None:
        return trace(scene, o[pixels], d[pixels], max_depth, stats)
    img = trace(scene, o, d, max_depth, stats)
    cam = scene.camera
    return img.reshape(cam["res_y"], cam["res_x"], 3)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """u8fromfloat (maths.h:113-117): x·255.99 saturated, truncated."""
    return (img.float() * 255.99).clamp(0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# the light fit's train step


def loss_of(scene: Scene, target: torch.Tensor, max_depth: int):
    """sum((render - target)²) over the pixels, over the pixel count."""
    img = render(scene, max_depth).reshape(-1, 3)
    n = scene.camera["res_x"] * scene.camera["res_y"]
    return ((img - target.reshape(-1, 3)) ** 2).sum() / float(n)


def with_normals_rederived(scene: Scene) -> Scene:
    """The scene with each triangle's normal re-derived from its edges,
    normalize(e1 × e2), with torch ops: what the program's update does to
    the primitive table after every step."""
    params = scene.params
    is_tri = (scene.ptype == TRIANGLE)[:, None]
    tri_n = normalize(torch.linalg.cross(params[:, 3:6], params[:, 6:9]))
    params = torch.where(is_tri, torch.cat([params[:, 0:9], tri_n], dim=-1),
                         params)
    return dataclasses.replace(scene, params=params,
                               tri=params[scene.tri_ids.long()])


def light_steps(scene: Scene, target: torch.Tensor, start: torch.Tensor,
                lr: float, steps: int, max_depth: int = 4):
    """Plain SGD on the lights' positions from ``start`` [L, 3], every
    other parameter held: (losses [steps], positions [steps + 1, L, 3],
    first gradient [L, 3], the scene after the last step). Each step's
    forward renders with the camera's frame re-derived from its eye and the
    triangles' normals from their edges, as the program's step applies its
    parameters to the scene before rendering (so the k-th step's camera is
    the built one re-derived k times)."""
    pos = start.detach().clone()
    losses, positions, first = [], [pos.clone()], None
    for _ in range(steps):
        scene = with_normals_rederived(with_eye(scene, scene.camera["eye"]))
        p = pos.clone().requires_grad_()
        loss = loss_of(with_light(scene, p), target, max_depth)
        (g,) = torch.autograd.grad(loss, [p])
        first = g.detach().clone() if first is None else first
        pos = (p - lr * g).detach()
        losses.append(float(loss.detach()))
        positions.append(pos.clone())
    return losses, torch.stack(positions), first, with_light(scene, pos)
