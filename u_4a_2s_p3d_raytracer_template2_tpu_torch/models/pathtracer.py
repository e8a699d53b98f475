"""Monte Carlo path tracer of the GLSL template (P3D_RT.glsl, common.glsl) in
PyTorch ops; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/models/pathtracer.py``, and the plain
version of the path-tracer kernel (models/pt_megakernel.py).

A batch of paths traces together: the bounce loop runs over masked SoA ray
state (dead paths keep their color and stop changing), one frame is a 1-spp
estimate, and the ``Accumulator`` (linear-space running sum + sample count)
is the checkpointable equivalent of the GLSL feedback texture
(P3D_RT.glsl:345-365; utils/checkpoint.py).

Material model (common.glsl:147-324): DIFFUSE cosine-ish scatter with
albedo·max(N·L,0)/π attenuation, METAL fuzzy mirror, DIELECTRIC with a
Schlick-probability branch between reflection and refraction plus Beer's-law
absorption. Direct lighting: Blinn-Phong with per-type constants and a shadow
feeler per light (P3D_RT.glsl:182-232).

Randomness: jax.random's threefry stream cannot be repeated in torch, so
every random number comes from an explicit ``torch.Generator``. Each bounce
consumes ``N_UNIFORMS`` raw U[0,1) rows; the keyed ``ray_color`` draws all
of them at once (``draw_uniforms``) and hands them to
``ray_color_presampled``, which the kernel computes too.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import constants as C
from ..core.types import Camera, Rays, dot, filled, normalize
from ..ops.camera import thin_lens_rays
from ..ops.sampling import (
    sample_unit_disk,
    uniform,
    unit_sphere_from_uniforms,
    unit_vector_from_uniforms,
)

MT_DIFFUSE = 0
MT_METAL = 1
MT_DIELECTRIC = 2

_EPS = 1e-3  # common.glsl:2
T_MIN = 1e-3
T_MAX = 1e4  # P3D_RT.glsl:243


@dataclasses.dataclass(frozen=True)
class PTMaterials:
    mtype: torch.Tensor          # [K] i32
    albedo: torch.Tensor         # [K,3]
    spec_color: torch.Tensor     # [K,3]
    roughness: torch.Tensor      # [K]
    ref_idx: torch.Tensor        # [K]
    refract_color: torch.Tensor  # [K,3]
    emissive: torch.Tensor       # [K,3]


@dataclasses.dataclass(frozen=True)
class PTScene:
    """Spheres (static + moving, lerped center — common.glsl:398-420) and
    triangles, SoA; per-primitive material ids; point lights."""

    sp_center0: torch.Tensor   # [N,3]
    sp_center1: torch.Tensor   # [N,3]
    sp_radius: torch.Tensor    # [N] (negative radius = hollow interior shell)
    sp_time0: torch.Tensor     # [N]
    sp_time1: torch.Tensor     # [N]
    sp_mat: torch.Tensor       # [N] i32
    tri_v0: torch.Tensor       # [M,3]
    tri_e1: torch.Tensor       # [M,3]
    tri_e2: torch.Tensor       # [M,3]
    tri_mat: torch.Tensor      # [M] i32
    materials: PTMaterials
    light_pos: torch.Tensor    # [L,3]
    light_color: torch.Tensor  # [L,3]
    # data an engine derives from the scene once and reuses on every frame
    # (the kernel's packed tables); not part of the scene's value
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.sp_radius.device


@dataclasses.dataclass(frozen=True)
class Accumulator:
    """Progressive estimate state — the feedback-texture equivalent
    (P3D_RT.glsl:345-365): linear-space sum + sample count."""

    sum_linear: torch.Tensor  # [H,W,3]
    count: torch.Tensor       # [] f32


@dataclasses.dataclass(frozen=True)
class PTConfig:
    max_bounces: int = C.MAX_BOUNCES
    russian_roulette: bool = False        # P3D_RT.glsl:4
    max_samples: int = C.MAX_SAMPLES      # P3D_RT.glsl:284
    # GLSL shadow feeler bug: tmax = length(normalized dir) == 1
    # (P3D_RT.glsl:195-197). False = physical distance-to-light bound.
    reference_shadow_len1: bool = False


@dataclasses.dataclass(frozen=True)
class PTHit:
    t: torch.Tensor       # [R]
    hit: torch.Tensor     # [R] bool
    point: torch.Tensor   # [R,3]
    normal: torch.Tensor  # [R,3]
    mat_id: torch.Tensor  # [R] i64


# ---------------------------------------------------------------------------
# intersections (GLSL forms)


def _sphere_ts(scene: PTScene, o, d, time, t_max):
    """hit_sphere/hit_movingSphere (common.glsl:427-506): half-b quadratic
    with the c>0 && b>0 early reject; lerped center for motion blur.
    Returns t [R,N] of every sphere (BIG where not hit below t_max) and the
    centers [R,N,3]."""
    span = scene.sp_time1 - scene.sp_time0
    frac = (time[:, None] - scene.sp_time0[None, :]) / torch.where(
        span == 0.0, 1.0, span)[None, :]
    frac = torch.where(span[None, :] == 0.0, 0.0, frac)
    center = (scene.sp_center0[None, :, :]
              + (scene.sp_center1 - scene.sp_center0)[None, :, :]
              * frac[:, :, None])                       # [R,N,3]
    L = o[:, None, :] - center
    b = dot(L, d[:, None, :])
    c = dot(L, L) - (scene.sp_radius * scene.sp_radius)[None, :]
    reject = (c > 0.0) & (b > 0.0)
    disc = b * b - c
    ok = ~reject & (disc >= 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 < 0.0, t1, t0)
    ok &= (t > T_MIN) & (t < t_max[:, None])
    return torch.where(ok, t, C.BIG), center


def _triangle_ts(scene: PTScene, o, d, t_max):
    """hit_triangle (common.glsl:335-380) — Möller–Trumbore with a 1e-7 det
    cutoff, checking u and v in [0,1] but not u+v<=1 (the GLSL quirk).
    Returns t [R,M] of every triangle (BIG where not hit below t_max)."""
    v0 = scene.tri_v0[None, :, :]
    e1 = scene.tri_e1[None, :, :]
    e2 = scene.tri_e2[None, :, :]
    dv = d[:, None, :]
    h = torch.linalg.cross(dv, e2)
    det = dot(h, e1)
    ok = torch.abs(det) > 1e-7
    f = 1.0 / torch.where(ok, det, 1.0)
    s = o[:, None, :] - v0
    u = f * dot(s, h)
    ok &= (u >= 0.0) & (u <= 1.0)
    q = torch.linalg.cross(s, e1)
    v = f * dot(dv, q)
    ok &= (v >= 0.0) & (v <= 1.0)
    t = f * dot(e2, q)
    ok &= (t > T_MIN) & (t < t_max[:, None])
    return torch.where(ok, t, C.BIG)


def hit_world(scene: PTScene, rays: Rays, t_max=None) -> PTHit:
    """Closest hit across the whole world (P3D_RT.glsl:12-180 brute force).
    Ties: the first minimum within a type; a triangle replaces a sphere only
    if strictly closer."""
    o, d = rays.origin, rays.direction
    if t_max is None:
        t_max = torch.full(o.shape[:1], T_MAX, dtype=o.dtype,
                           device=o.device)
    t_sph, centers = _sphere_ts(scene, o, d, rays.time, t_max)
    ts, si = torch.min(t_sph, dim=-1)   # first minimum, as argmin
    tt, ti = torch.min(_triangle_ts(scene, o, d, t_max), dim=-1)

    use_tri = tt < ts
    t = torch.where(use_tri, tt, ts)
    hit = t < C.BIG

    point = o + d * t[:, None]
    # sphere normal: sign of radius picks shell orientation (common.glsl:460)
    csel = torch.gather(centers, 1, si[:, None, None].expand(-1, 1, 3))[:, 0]
    rsel = scene.sp_radius[si]
    n_sph = normalize(point - csel) * torch.sign(rsel)[:, None]
    n_tri = normalize(torch.linalg.cross(scene.tri_e1[ti], scene.tri_e2[ti]))
    normal = torch.where(use_tri[:, None], n_tri, n_sph)

    mat = torch.where(use_tri, scene.tri_mat[ti], scene.sp_mat[si]).long()
    return PTHit(t, hit, point, normal, mat)


# ---------------------------------------------------------------------------
# direct lighting (P3D_RT.glsl:182-232)


def direct_lighting(scene: PTScene, cfg: PTConfig, rays: Rays, hit: PTHit,
                    mats: PTMaterials) -> torch.Tensor:
    out = torch.zeros_like(hit.point)
    n_lights = scene.light_pos.shape[0]
    mtype = mats.mtype[hit.mat_id]
    albedo = mats.albedo[hit.mat_id]
    is_diff = mtype == MT_DIFFUSE

    # per-type Blinn-Phong constants (P3D_RT.glsl:201-219)
    diff_col = torch.where(is_diff[:, None], albedo, 0.0)
    spec_col = torch.where(
        is_diff[:, None], 0.1,
        torch.where((mtype == MT_METAL)[:, None], albedo, 0.004))
    shininess = torch.where(is_diff, 10.0, 100.0)
    kd = torch.where(is_diff, 1.0, 0.0)
    ks = torch.where(is_diff, 0.0, 1.0)

    for li in range(n_lights):
        lpos = scene.light_pos[li]
        lcol = scene.light_color[li][None, :]
        ldir = normalize(lpos[None, :] - hit.point)
        ndl = dot(hit.normal, ldir)
        facing = ndl > 0.0

        feeler_o = hit.point + _EPS * hit.normal
        if cfg.reference_shadow_len1:
            max_t = torch.ones_like(ndl)
        else:
            max_t = torch.linalg.vector_norm(lpos[None, :] - hit.point,
                                             dim=-1)
        sh = hit_world(scene, Rays(feeler_o, ldir, rays.time), max_t)
        lit = facing & ~sh.hit & hit.hit

        H = normalize(ldir - rays.direction)
        nh = torch.clamp(dot(hit.normal, H), min=0.0)
        dterm = lcol * diff_col * torch.clamp(ndl, min=0.0)[:, None]
        sterm = lcol * spec_col * torch.pow(nh, shininess)[:, None]
        out = out + torch.where(lit[:, None], dterm * kd[:, None]
                                + sterm * ks[:, None], 0.0)
    return out


# ---------------------------------------------------------------------------
# scatter (common.glsl:216-324)


# Raw U[0,1) draws consumed per bounce, in stream order: 3 for the diffuse
# unit vector, 3 for the metal fuzz sphere, 1 reflect-probability, 3 for the
# shared dielectric refl/blend sphere, 1 Russian-roulette.
N_UNIFORMS = 11


def draw_uniforms(generator: torch.Generator, n_bounces: int,
                  R: int) -> torch.Tensor:
    """[B, N_UNIFORMS, R] raw draws for the pre-sampled integrator, on the
    generator's device."""
    return uniform(generator, (n_bounces, N_UNIFORMS, R))


def scatter_presampled(u, cfg: PTConfig, rays: Rays, hit: PTHit,
                       mats: PTMaterials):
    """Scatter from pre-drawn uniforms u: [>=10, R] (rows 0-9 used).
    Returns (new_rays, atten [R,3], scattered mask)."""
    mtype = mats.mtype[hit.mat_id]
    albedo = mats.albedo[hit.mat_id]
    spec = mats.spec_color[hit.mat_id]
    rough = mats.roughness[hit.mat_id]
    ref_idx = mats.ref_idx[hit.mat_id]
    refract_color = mats.refract_color[hit.mat_id]

    d = rays.direction
    n = hit.normal
    precise = hit.point + n * _EPS

    # DIFFUSE (common.glsl:220-227)
    s_point = hit.point + n + unit_vector_from_uniforms(u[0], u[1], u[2])
    d_diff = normalize(s_point - hit.point)
    a_diff = albedo * torch.clamp(dot(d_diff, n), min=0.0)[:, None] / math.pi
    o_diff = precise

    # METAL (common.glsl:229-240): fuzzy mirror, direction NOT renormalized
    mirror = normalize(d - 2.0 * dot(d, n)[:, None] * n)
    d_metal = mirror + rough[:, None] * unit_sphere_from_uniforms(
        u[3], u[4], u[5])
    a_metal = spec
    o_metal = precise

    # DIELECTRIC (common.glsl:241-322)
    ddn = dot(d, n)
    inside = ddn > 0.0
    outward = torch.where(inside[:, None], -n, n)
    ni_over_nt = torch.where(inside, ref_idx, 1.0 / ref_idx)
    cosine = torch.where(inside, ddn, -ddn)
    eta_i = torch.where(inside, ref_idx, 1.0)
    eta_t = torch.where(inside, 1.0, ref_idx)

    r0 = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r0 * r0  # schlick() squares (common.glsl:212)
    k_tir = 1.0 - ni_over_nt * ni_over_nt * (1.0 - cosine * cosine)
    tir = k_tir < 0.0
    om = 1.0 - cosine
    om2 = om * om
    # (1-cos)^5 by squaring, the order of jax.lax.integer_pow
    reflect_prob = torch.where(tir, 1.0, r0 + (1.0 - r0) * (om * (om2 * om2)))

    do_reflect = u[6] < reflect_prob
    # reflect branch uses rec.normal, not outwardNormal (common.glsl:296);
    # the same sphere sample feeds both the fuzz and the rough-blend below
    sph4 = unit_sphere_from_uniforms(u[7], u[8], u[9])
    d_refl = mirror + rough[:, None] * sph4
    o_refl = hit.point + outward * _EPS

    sqk = torch.sqrt(torch.clamp(k_tir, min=0.0))
    d_refr = normalize(ni_over_nt[:, None] * d
                       + (ni_over_nt * cosine - sqk)[:, None] * outward)
    blend = normalize(outward + sph4)
    rr = (rough * rough)[:, None]
    d_refr = d_refr * (1.0 - rr) + blend * rr  # mix() (common.glsl:307)
    o_refr = hit.point - outward * _EPS
    beer = torch.exp(refract_color * (-hit.t[:, None]))  # common.glsl:314

    d_diel = torch.where(do_reflect[:, None], d_refl, d_refr)
    o_diel = torch.where(do_reflect[:, None], o_refl, o_refr)
    a_diel = albedo * torch.where(do_reflect[:, None], 1.0, beer)

    is_m = (mtype == MT_METAL)[:, None]
    is_d = (mtype == MT_DIELECTRIC)[:, None]
    new_d = torch.where(is_d, d_diel, torch.where(is_m, d_metal, d_diff))
    new_o = torch.where(is_d, o_diel, torch.where(is_m, o_metal, o_diff))
    atten = torch.where(is_d, a_diel, torch.where(is_m, a_metal, a_diff))

    return Rays(new_o, new_d, rays.time), atten, hit.hit


# ---------------------------------------------------------------------------
# the bounce loop (rayColor, P3D_RT.glsl:236-282)


_SKY_TOP = (0.5, 0.7, 1.0)


def _bounce(scene: PTScene, cfg: PTConfig, u, state):
    """One bounce of the integrator from pre-drawn uniforms u [N_UNIFORMS, R].
    state = (rays, throughput, col, active)."""
    rays, throughput, col, active = state
    mats = scene.materials
    hit = hit_world(scene, rays)

    # background (P3D_RT.glsl:274-279)
    tt = 0.8 * (rays.direction[:, 1] + 1.0)
    top = filled(_SKY_TOP, col.dtype, col.device)
    sky = (1.0 - tt)[:, None] + tt[:, None] * top
    miss = active & ~hit.hit
    col = col + torch.where(miss[:, None], throughput * sky, 0.0)

    live = active & hit.hit
    dl = direct_lighting(scene, cfg, rays, hit, mats)
    col = col + torch.where(live[:, None], throughput * dl, 0.0)

    new_rays, atten, scattered = scatter_presampled(u, cfg, rays, hit, mats)
    throughput = torch.where(live[:, None], throughput * atten, throughput)
    rays = Rays(
        torch.where(live[:, None], new_rays.origin, rays.origin),
        torch.where(live[:, None], new_rays.direction, rays.direction),
        rays.time,
    )
    active = live & scattered

    if cfg.russian_roulette:  # P3D_RT.glsl:265-271
        p = throughput.amax(dim=-1)
        kill = active & (u[10] > p)
        active = active & ~kill
        throughput = torch.where(
            active[:, None], throughput / torch.clamp(p, min=1e-8)[:, None],
            throughput)
    return (rays, throughput, col, active)


def ray_color_presampled(scene: PTScene, cfg: PTConfig, rays: Rays,
                         uni: torch.Tensor) -> torch.Tensor:
    """[R,3] color of rays from pre-drawn uniforms uni [B, 11, R]
    (draw_uniforms), B bounces at most.

    The plain version of the path-tracer kernel: fed the same uniforms, the
    two give the same image up to f32 reassociation. On CPU tensors the
    loop ends when every path is dead; on CUDA tensors it runs every
    bounce, reading nothing back to the host, so that a frame can be
    captured as a CUDA graph (``pt_megakernel.make_render_frame``): a dead
    path adds +0.0 to its color, so the image is the same."""
    R = rays.origin.shape[0]
    state = (rays, rays.origin.new_ones((R, 3)), rays.origin.new_zeros((R, 3)),
             torch.ones(R, dtype=torch.bool, device=rays.origin.device))
    on_cpu = rays.origin.device.type == "cpu"
    for i in range(uni.shape[0]):
        if on_cpu and not bool(state[3].any()):  # a dead path adds nothing
            break
        state = _bounce(scene, cfg, uni[i], state)
    return state[2]


def ray_color(scene: PTScene, cfg: PTConfig, rays: Rays,
              generator: torch.Generator) -> torch.Tensor:
    """[R,3] color of rays, their [max_bounces, 11, R] uniforms drawn from
    ``generator`` in one call."""
    uni = draw_uniforms(generator, cfg.max_bounces, rays.origin.shape[0])
    return ray_color_presampled(scene, cfg, rays, uni)


# ---------------------------------------------------------------------------
# per-frame estimate + progressive accumulation (mainImage, P3D_RT.glsl:286-366)


def make_accumulator(res_x: int, res_y: int, *, device) -> Accumulator:
    return Accumulator(
        torch.zeros((res_y, res_x, 3), dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.float32, device=device))


def camera_rays(cam: Camera, generator: torch.Generator, px=None,
                py=None) -> Rays:
    """The primary rays of the pixels (px, py) [R] (default the whole frame,
    row 0 = bottom): pixel jitter [R,2] with no +0.5 offset, a lens disk
    sample scaled by aperture·0.5 (common.glsl:120) and a shutter time, all
    drawn from ``generator`` in that order."""
    if px is None:
        from .whitted import pixel_grid

        px, py = pixel_grid(cam.res_x, cam.res_y, generator.device)
    R = px.shape[0]
    jit2 = uniform(generator, (R, 2))
    lens = sample_unit_disk(generator, (R,)) * (cam.aperture * 0.5)
    time = cam.time0 + uniform(generator, (R,)) * (cam.time1 - cam.time0)
    return thin_lens_rays(cam, px + jit2[:, 0], py + jit2[:, 1], lens, time)


def render_frame(scene: PTScene, cam: Camera, cfg: PTConfig,
                 generator: torch.Generator) -> torch.Tensor:
    """One 1-spp jittered estimate of the full frame, linear space. [H,W,3]

    Draws from ``generator`` in this order: ``camera_rays``, then the
    ``[B, 11, R]`` uniforms; ``pt_megakernel.make_render_frame`` draws the
    same, so one seed gives comparable frames from both."""
    rays = camera_rays(cam, generator)
    col = ray_color(scene, cfg, rays, generator)
    return col.reshape(cam.res_y, cam.res_x, 3)


def accumulate(acc: Accumulator, frame: torch.Tensor) -> Accumulator:
    """Running linear-space sum; the max_samples cap is the caller's
    (P3D_RT.glsl:357-364)."""
    return Accumulator(acc.sum_linear + frame, acc.count + 1.0)


def to_image(acc: Accumulator) -> torch.Tensor:
    """Gamma-2.2 display image (toGamma, common.glsl:66-69)."""
    mean = acc.sum_linear / torch.clamp(acc.count, min=1.0)
    return torch.pow(torch.clamp(mean, 0.0, 1.0), 1.0 / 2.2)


def render_progressive(scene: PTScene, cam: Camera, cfg: PTConfig,
                       generator: torch.Generator, n_frames: int,
                       acc: Accumulator | None = None,
                       start_count: float | None = None,
                       frame_fn=None) -> Accumulator:
    """Accumulate up to n_frames 1-spp estimates, respecting the max_samples
    cap (P3D_RT.glsl:357-361). The cap check uses a host-side frame counter
    (``start_count`` when resuming), so frames do not wait on the device.

    ``frame_fn``: generator -> [H,W,3] estimator (e.g.
    ``pt_megakernel.make_render_frame``); default ``render_frame``."""
    if acc is None:
        acc = make_accumulator(cam.res_x, cam.res_y, device=scene.device)
        count = 0.0
    else:
        count = float(acc.count) if start_count is None else start_count
    if frame_fn is None:
        def frame_fn(g):
            return render_frame(scene, cam, cfg, g)
    for _ in range(n_frames):
        if count >= cfg.max_samples:
            break
        acc = accumulate(acc, frame_fn(generator))
        count += 1.0
    return acc
