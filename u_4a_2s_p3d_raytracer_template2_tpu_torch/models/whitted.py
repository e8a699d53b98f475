"""Whitted ray tracer — the reference's rayTracing/renderScene
(main.cpp:530-832) as an iterative level sweep over a static binary
recursion tree; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/models/whitted.py``.

Depth-``D`` recursion with (reflection, refraction) children becomes ``D``
levels; level ``l`` holds ``R·2^l`` ray slots (slot ``2i`` = reflection
child, ``2i+1`` = refraction child of slot ``i``). The forward sweep traces
and locally shades each level; the backward sweep folds children into
parents with ``local + KR·specColor·refl + (1-KR)·refr`` (main.cpp:719).
Everything is masked rather than branched: inactive slots trace with
direction (0,0,1) and contribute zero.

``engine="megakernel"`` hands the whole tree to one CUDA kernel on CUDA
tensors (models/whitted_megakernel.py). In a BVH or grid scene the sweep's
closest-hit and shadow queries walk the scene's BVH tables
(accel/packets.py: the CUDA walk on CUDA tensors, its plain version on CPU
tensors); in a brute-force scene (or under ``accel_impl="brute"``) they
test every primitive (ops/intersect.py: above 48 primitives the CUDA
brute-force kernels on CUDA tensors, their plain version on CPU
tensors).

Distribution mode (main.cpp:757-798: the spp×spp anti-aliasing scan, thin-lens
depth of field, motion-blur shutter times, jittered soft shadows, fuzzy
reflection) takes its random values from a sample plan drawn before the
trace (models/samples.py); misses read the skybox when ``use_skybox`` is set
and the scene has one. The wavefront engine and the reference BVH walk and
grid DDA (``accel_impl="perray"``) are not ported yet and raise.
"""
from __future__ import annotations

import torch

from ..core import constants as C
from ..core.types import RenderConfig, Rays, Scene, clamp01, dot, normalize
from ..ops import intersect, shade
from ..ops.camera import primary_rays
from .samples import (
    Draws,
    draw_subpixel,
    scene_layout,
    stream_rows,
    subpixels,
)

_EPS = C.EPSILON


def check_config(cfg: RenderConfig) -> None:
    """Raise NotImplementedError for a config outside the ported envelope."""
    if cfg.engine == "wavefront":
        raise NotImplementedError(
            "the wavefront engine is not ported yet (ROADMAP.md, queue 1, "
            "item 8 'Wavefront engine')")
    if cfg.engine not in ("sweep", "megakernel"):
        raise ValueError(f"unknown engine {cfg.engine!r}")


# ---------------------------------------------------------------------------
# closest-hit and shadow dispatch (JAX models/whitted.py:45-199)

_PERRAY = ("accel_impl='perray' (the reference BVH walk and the grid DDA of "
           "accel/traverse.py) is not ported yet (ROADMAP.md, queue 1, item 9 "
           "'Accelerators')")


def _bvh_impl(cfg: RenderConfig | None) -> str:
    """Resolve ``cfg.accel_impl`` for a BVH or grid scene: "walk" (the
    BVH walk of accel/packets.py, for "auto", "packets", "clusters" and
    "multi") or "brute"."""
    impl = cfg.accel_impl if cfg is not None else "auto"
    if impl in ("auto", "packets", "clusters", "multi"):
        return "walk"
    if impl == "brute":
        return "brute"
    if impl == "perray":
        raise NotImplementedError(_PERRAY)
    raise ValueError(f"unknown accel_impl {impl!r}")


def _walks(scene: Scene, cfg: RenderConfig | None) -> bool:
    return (scene.accel_type in (C.ACCEL_BVH, C.ACCEL_GRID)
            and _bvh_impl(cfg) == "walk" and scene.packets is not None)


def trace_closest(scene: Scene, rays: Rays, cfg: RenderConfig | None = None):
    """Closest hit via the scene's accelerator; returns (t, obj_id)."""
    if _walks(scene, cfg):
        from ..accel.packets import packet_closest_hit

        return packet_closest_hit(scene.packets, rays)
    return intersect.closest_hit_brute(scene.prims, rays, scene.brute)


def _grid_initfail(scene: Scene, cfg: RenderConfig | None) -> bool:
    return (scene.accel_type == C.ACCEL_GRID and cfg is not None
            and cfg.reference_grid_shadow_initfail)


def trace_shadow(scene: Scene, rays: Rays, max_t,
                 cfg: RenderConfig | None = None, dead=None):
    """Any-hit occlusion via the scene's accelerator. ``dead`` [R] bool
    marks lanes the caller masks downstream: the walk and brute force report
    them occluded without a test."""
    if _grid_initfail(scene, cfg):
        raise NotImplementedError(
            "reference_grid_shadow_initfail needs the grid DDA: " + _PERRAY)
    if _walks(scene, cfg):
        from ..accel.packets import packet_any_hit

        return packet_any_hit(scene.packets, rays, max_t, dead)
    return intersect.any_hit_brute(scene.prims, rays, max_t, dead,
                                   scene.brute)


def _shadow_multi_rows(scene: Scene, cfg: RenderConfig, hit_point, precise,
                       normal, active):
    """[L, R] hard-shadow occlusion of every light in one fused walk
    (accel/packets.packet_any_hit_multi) under ``accel_impl="multi"`` with
    two or more lights; None where the per-light queries apply."""
    if (cfg.accel_impl != "multi" or scene.n_lights < 2
            or not _walks(scene, cfg) or _grid_initfail(scene, cfg)):
        return None
    from ..accel.packets import packet_any_hit_multi

    Lvs = [scene.lights.position[li][None, :] - hit_point
           for li in range(scene.n_lights)]
    dead = [~(active & (dot(Lv, normal) > 0.0)) for Lv in Lvs]
    max_t = C.BIG if cfg.shadow_unbounded else 1.0
    return packet_any_hit_multi(scene.packets, precise, Lvs, max_t, dead)


# ---------------------------------------------------------------------------
# direct lighting (processLight + the 4x4 soft-shadow grid, main.cpp:593-630)


def direct_lighting(scene: Scene, rays: Rays, hit_point, precise, normal,
                    mat: shade.MatView, active, cfg: RenderConfig,
                    jitter=None):
    """Blinn-Phong over the lights with shadow rays. ``jitter``: per light,
    the (jx, jy) [R] light offsets of soft shadows under AA."""
    color = torch.zeros_like(hit_point)
    max_t = C.BIG if cfg.shadow_unbounded else 1.0
    multi_occ = None
    if not cfg.soft_shadow:
        multi_occ = _shadow_multi_rows(scene, cfg, hit_point, precise,
                                       normal, active)

    def one_sample(position, light_color, occluded=None):
        Lv = position - hit_point  # unnormalized (main.cpp:627)
        facing = dot(Lv, normal) > 0.0
        if occluded is None:
            # lanes whose contribution is masked below need no walk
            occluded = trace_shadow(scene, Rays(precise, Lv, rays.time),
                                    max_t, cfg, dead=~(active & facing))
        lit = active & facing & ~occluded
        return shade.blinn_phong(Lv, lit, light_color, mat, rays.direction,
                                 normal)

    for li in range(max(scene.n_lights, 1)):
        lpos = scene.lights.position[li]
        lcol = scene.lights.color[li][None, :]
        if cfg.soft_shadow and not cfg.anti_aliasing:
            # 4x4 grid of light positions, each 1/16 of the color
            # (main.cpp:601-618): spacing 0.125, start at pos - 0.25
            distance = 0.5 / 4.0
            start = -distance * 0.5 * 4.0
            for i in range(4):
                for j in range(4):
                    off = torch.tensor(
                        [start + j * distance, start + i * distance, 0.0],
                        dtype=lpos.dtype, device=lpos.device)
                    color = color + one_sample((lpos + off)[None, :],
                                               lcol / 16.0)
        elif cfg.soft_shadow:
            # one jittered light position tied to the AA subpixel
            # (main.cpp:621-624); a scene without lights has a black
            # placeholder light and no rows
            zero = torch.zeros_like(hit_point[:, 0])
            jx, jy = jitter[li] if li < len(jitter) else (zero, zero)
            pos = lpos[None, :] + torch.stack([jx, jy, torch.zeros_like(jx)],
                                              dim=-1)
            color = color + one_sample(pos, lcol)
        else:
            color = color + one_sample(
                lpos[None, :], lcol,
                None if multi_occ is None else multi_occ[li])
    return color


# ---------------------------------------------------------------------------
# one recursion level


def _level_step(scene: Scene, rays: Rays, active, ior_in, cfg: RenderConfig,
                spawn: bool, lvl: int, layout, rows):
    """Trace + locally shade level ``lvl``; optionally emit children.
    ``layout``/``rows``: the stream layout and the trace's sample values
    (models/samples.py; ``rows`` None when the layout has none)."""
    t_disc, obj_id = trace_closest(scene, rays, cfg)
    hit = active & (obj_id >= 0)

    params, ptype, mat_id = intersect.gather_prims(scene.prims, obj_id)
    present = (scene.prims.n_sph > 0, scene.prims.n_tri > 0,
               scene.prims.n_pl > 0, scene.prims.n_box > 0)
    # re-intersection of the winner primitive; borderline hits the
    # re-derivation rejects under f32 re-association fall back to the
    # traversal's t
    t = intersect.per_ray_t(params, ptype, rays.origin, rays.direction,
                            present)
    t = torch.where(t >= C.BIG, t_disc, t)
    t = torch.where(hit, t, 1.0)

    hit_point = rays.origin + rays.direction * t[:, None]
    normal = normalize(intersect.per_ray_normal(
        params, ptype, hit_point, rays.origin, rays.direction, present))
    precise = hit_point + normal * _EPS

    mat = shade.gather_materials(scene.materials, mat_id)
    jitter = None
    if layout.soft_jit:
        jitter = [tuple(layout.level_values(rows, lvl, 2 * li + k)
                        for k in range(2)) for li in range(layout.n_lights)]
    local = direct_lighting(scene, rays, hit_point, precise, normal, mat,
                            hit, cfg, jitter)

    # miss color: the flat background, or the skybox (scene.cpp:383-461)
    miss = active & (obj_id < 0)
    if cfg.use_skybox and scene.has_skybox:
        bg = shade.skybox_color(scene.skybox, rays.direction, valid=miss)
    else:
        bg = scene.bg_color[None, :].expand(local.shape)

    if not spawn:
        # depth == MAX_DEPTH leaf: clamp local color (main.cpp:632-634)
        color = torch.where(hit[:, None], clamp01(local), 0.0)
        return torch.where(miss[:, None], bg, color), None

    # flip the normal for secondary-ray math only (main.cpp:639-643)
    inside = dot(rays.direction, normal) > 0.0
    nf = torch.where(inside[:, None], -normal, normal)

    # reflection child (main.cpp:646-667)
    refl_dir = normalize(shade.reflect_dir(rays.direction, nf))
    if layout.has_fuzzy(lvl):
        off = layout.fuzzy_offset()
        sphere = torch.stack([layout.level_values(rows, lvl, off + k)
                              for k in range(3)], dim=-1)
        refl_dir = shade.fuzzy_reflect_dir(refl_dir, nf, cfg.roughness,
                                           sphere)
    refl_active = hit & (mat.ks > 0.0)
    refl_rays = Rays(precise, refl_dir, rays.time)

    # refraction child (main.cpp:671-697); inactive lanes get a finite
    # default direction
    ro = shade.refract(rays.direction, nf, inside, ior_in, mat.ior,
                       cfg.refraction_mode)
    refr_active = hit & (mat.transmit != 0.0) & ro.can_refract
    default_dir = torch.tensor([0.0, 0.0, 1.0], dtype=local.dtype,
                               device=local.device).expand(ro.direction.shape)
    refr_dir = torch.where(refr_active[:, None], ro.direction, default_dir)
    refr_origin = torch.where(refr_active[:, None],
                              hit_point + refr_dir * 0.001, precise)
    refr_rays = Rays(refr_origin, refr_dir, rays.time)

    kr = shade.fresnel_kr(ro, ior_in, mat.transmit, mat.ks, cfg.fresnel_mode)

    local_color = torch.where(hit[:, None], local, 0.0)
    local_color = torch.where(miss[:, None], bg, local_color)

    children = dict(
        refl=(refl_rays, refl_active, ior_in),
        refr=(refr_rays, refr_active, ro.new_ior),
    )
    fold = dict(kr=kr, spec_color=mat.spec_color, hit=hit)
    return local_color, (children, fold)


def _interleave(a, b):
    """[R,...],[R,...] -> [2R,...] with a at even, b at odd slots."""
    return torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:]))


def trace_rays(scene: Scene, rays: Rays, cfg: RenderConfig,
               rows: torch.Tensor | None = None,
               offsets=None) -> torch.Tensor:
    """Color for a batch of primary rays — the full Whitted tree. [R,3]

    Subtrees that can never activate are pruned statically: reflection
    children exist only if some material has Ks>0 (main.cpp:646), refraction
    children only if some material has T!=0 (main.cpp:671). ``rows``
    [n_rows, R]: the raw draws of jittered soft shadows and fuzzy
    reflection (models/samples.py), when the config has them; ``offsets``
    the (i, j) subpixel indices the light offsets are tied to
    (main.cpp:779-780).
    """
    check_config(cfg)
    R = rays.origin.shape[0]
    layout = scene_layout(scene, cfg)
    if layout.n_rows and (rows is None
                          or tuple(rows.shape) != (layout.n_rows, R)):
        raise ValueError(
            f"this config reads {layout.n_rows} sample rows of {R} rays; got "
            f"{None if rows is None else tuple(rows.shape)}")
    if layout.n_rows:
        rows = stream_rows(rows, layout, offsets, cfg.spp)
    dev = rays.origin.device
    spawn_refl = scene.has_reflective
    spawn_refr = scene.has_transmissive
    ones_b = torch.ones(R, dtype=torch.bool, device=dev)
    ones_f = torch.ones(R, dtype=rays.origin.dtype, device=dev)

    if not (spawn_refl or spawn_refr):
        # no secondary rays possible: single unclamped local+bg level
        local_color, _ = _level_step(scene, rays, ones_b, ones_f, cfg, True,
                                     0, layout, rows)
        return local_color

    levels = []
    cur_rays, cur_active, cur_ior = rays, ones_b, ones_f
    for lvl in range(cfg.max_depth):
        spawn = lvl < cfg.max_depth - 1
        color, nxt = _level_step(scene, cur_rays, cur_active, cur_ior, cfg,
                                 spawn, lvl, layout, rows)
        if not spawn:
            break
        children, fold = nxt
        levels.append((color, fold))
        refl_rays, refl_act, refl_ior = children["refl"]
        refr_rays, refr_act, refr_ior = children["refr"]
        if spawn_refl and spawn_refr:
            cur_rays = Rays(
                _interleave(refl_rays.origin, refr_rays.origin),
                _interleave(refl_rays.direction, refr_rays.direction),
                _interleave(refl_rays.time, refr_rays.time),
            )
            cur_active = _interleave(refl_act, refr_act)
            cur_ior = _interleave(refl_ior, refr_ior)
        elif spawn_refl:
            cur_rays, cur_active, cur_ior = refl_rays, refl_act, refl_ior
        else:
            cur_rays, cur_active, cur_ior = refr_rays, refr_act, refr_ior

    # backward fold: children -> parents (main.cpp:719)
    child_color = color
    for local_color, fold in reversed(levels):
        if spawn_refl and spawn_refr:
            refl, refr = child_color[0::2], child_color[1::2]
        elif spawn_refl:
            refl, refr = child_color, 0.0
        else:
            refl, refr = 0.0, child_color
        kr = fold["kr"][:, None]
        combined = (local_color + refl * kr * fold["spec_color"]
                    + refr * (1.0 - kr))
        # only hits spawn children; misses keep their bg color untouched
        child_color = torch.where(fold["hit"][:, None], combined, local_color)
    return child_color


# ---------------------------------------------------------------------------
# pixel loop (renderScene, main.cpp:732-832)


def _stochastic(layout, cfg: RenderConfig) -> bool:
    return bool(cfg.anti_aliasing or cfg.depth_of_field or cfg.motion_blur
                or layout.n_rows)


def subpixel_rays(scene: Scene, px: torch.Tensor, py: torch.Tensor,
                  cfg: RenderConfig, s: Draws) -> Rays:
    """The primary rays of one subpixel's draws ``s``: the pixel centre, or
    under AA the subpixel (i, j) jittered by ``s.jitter``
    (main.cpp:777-798), through the pinhole or the thin lens."""
    if s.ij is None:
        sx, sy = px + 0.5, py + 0.5
    else:
        spp = max(cfg.spp, 1)
        sx = px + (s.ij[0] + s.jitter[:, 0]) / spp
        sy = py + (s.ij[1] + s.jitter[:, 1]) / spp
    return primary_rays(scene.camera, sx, sy,
                        depth_of_field=cfg.depth_of_field,
                        motion_blur=cfg.motion_blur, time_u=s.time,
                        lens_u=s.lens)


def render_samples(scene: Scene, px: torch.Tensor, py: torch.Tensor,
                   cfg: RenderConfig, trace, generator=None,
                   draws=None) -> torch.Tensor:
    """renderScene's per-pixel loop (main.cpp:757-805) over the tile's
    pixels: one sample at the pixel centre, or under anti-aliasing the
    spp×spp jittered subpixels, each clamped, summed and divided by spp²
    (by 16 under ``reference_aa_div16``, main.cpp:800). ``trace(scene,
    rays, cfg, rows, ij)`` gives a subpixel's clamped [R,3] color. ``draws``:
    one ``samples.Draws`` per subpixel; else each subpixel draws its own
    from ``generator`` (a generator seeded 0 on the scene's device if
    None) just before it is traced."""
    R = px.shape[0]
    layout = scene_layout(scene, cfg)
    stochastic = _stochastic(layout, cfg)
    if draws is None and stochastic and generator is None:
        generator = torch.Generator(device=scene.device).manual_seed(0)
    acc = None
    for k, ij in enumerate(subpixels(cfg)):
        if draws is not None:
            s = draws[k]
        elif stochastic:
            s = draw_subpixel(generator, layout, cfg, R, ij)
        else:
            s = Draws(None, None, None, None, None)
        color = trace(scene, subpixel_rays(scene, px, py, cfg, s), cfg,
                      s.rows, ij)
        acc = color if acc is None else acc + color
    if not cfg.anti_aliasing:
        return acc
    spp = max(cfg.spp, 1)
    return acc / (16.0 if cfg.reference_aa_div16 else float(spp * spp))


def _sweep_trace(scene, rays, cfg, rows, offsets):
    return clamp01(trace_rays(scene, rays, cfg, rows, offsets))


def render_tile(scene: Scene, px: torch.Tensor, py: torch.Tensor,
                cfg: RenderConfig, generator=None,
                draws=None) -> torch.Tensor:
    """Render a flat batch of pixel indices px, py -> [R,3] colors in [0,1]
    (``render_samples``'s loop).

    On CUDA tensors ``engine="megakernel"`` launches the CUDA kernel (once
    a subpixel) or raises; on CPU tensors it runs the kernel's plain
    version.
    """
    check_config(cfg)
    if cfg.engine == "megakernel":
        from .whitted_megakernel import render_tile as mk_render_tile

        return mk_render_tile(scene, px, py, cfg, generator, draws)
    return render_samples(scene, px, py, cfg, _sweep_trace, generator, draws)


def pixel_grid(res_x: int, res_y: int, device) -> tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Flat (px, py) pixel indices, row-major with row 0 at the bottom."""
    ys, xs = torch.meshgrid(
        torch.arange(res_y, dtype=torch.float32, device=device),
        torch.arange(res_x, dtype=torch.float32, device=device),
        indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def render_image(scene: Scene, cfg: RenderConfig, generator=None, *,
                 tile_rows: int = 0) -> torch.Tensor:
    """Full-frame render -> [res_y, res_x, 3] float image in [0,1] on the
    scene's device, ``tile_rows`` image rows a tile (0: one tile), the
    tiles drawing in turn from ``generator``.

    Row y=0 is the bottom scanline, as in the reference's framebuffer
    (main.cpp:749-805 fills bottom-up).
    """
    cam = scene.camera
    px, py = pixel_grid(cam.res_x, cam.res_y, scene.device)
    n = cam.res_y * cam.res_x
    if generator is None and _stochastic(scene_layout(scene, cfg), cfg):
        generator = torch.Generator(device=scene.device).manual_seed(0)
    tile = n if tile_rows <= 0 else tile_rows * cam.res_x
    chunks = [render_tile(scene, px[a:a + tile], py[a:a + tile], cfg,
                          generator) for a in range(0, n, tile)]
    return torch.cat(chunks, dim=0).reshape(cam.res_y, cam.res_x, 3)
