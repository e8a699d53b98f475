"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each raising on failure:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile csrc/whitted_megakernel.cu and csrc/pt_megakernel.cu
     with nvcc, one process each, started together; print the build times
     and ptxas's register and spill report.
  Whitted path (mount_low 512x512, depth 4):
  3. kernel against plain: the CUDA kernel against its plain PyTorch version
     on the same rays, at 64x64 depth 4 (mount_low under all 12 Fresnel x
     refraction x shadow combinations, a four-type scene with 2 lights, a
     66-primitive sphere field) and at the main path's 512x512;
  4. main path: render_image of mount_low at 512x512, depth 4,
     engine="megakernel", with the kernel's launch counter reset just before
     and read just after; the image against the plain sweep; the PNG; the
     CLI render command as a subprocess;
  5. timing: kernel and plain version alone, and whole frames of both
     engines, as medians of CUDA-event times; a megakernel frame's
     breakdown under torch.profiler; the work that sets the kernel's bound.
  Path-tracer path (glsl_world 512x512, 10 bounces, progressive):
  6. kernel against plain on the same rays and uniforms: a seven-sphere,
     two-triangle, two-light world that reaches every branch at 64x64 under
     four configs, and glsl_world at 512x512, 10 bounces;
  7. main path: render_progressive of glsl_world, 16 frames on the
     megakernel engine, with the kernel's launch counter reset just before
     and read just after; the image against the plain engine from the same
     seed; the PNG; the CLI pathtrace command as two subprocesses, the
     second resuming the first's checkpoint;
  8. timing: kernel and plain version alone, a whole megakernel frame and
     its breakdown under torch.profiler, and the live bounces per path that
     set the kernel's bound.
The line before the last is a JSON object of the kernels; the last line is
the JSON device record.
"""
import concurrent.futures
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ATOL = 2e-3       # per-pixel tolerance of the repo's image comparison
MAX_BAD = 0.01    # fraction of pixels allowed beyond ATOL (silhouette flips)
# The path tracer's kernel against its plain version on the same rays and
# uniforms, per case: (share of pixels beyond ATOL, mean abs difference)
# allowed. A reflect/refract draw that flips under f32 reordering changes a
# whole path, so a few pixels may differ by a lot. Each limit lies between
# what the sound kernel reads and what kernels with planted faults read
# (chip_faults.py, H100 80GB HBM3; the readings are in PERF.md): sound 0
# pixels and a mean of 6.7e-8 on the tiny world, where a dropped dielectric
# highlight reads 8.3e-7; 0.0126% and 7.7e-6 at 512x512, where the same
# fault reads 0.049% and a triangle u+v guard 7.8e-5.
PT_LIMITS = {
    "tiny": (0.0005, 2.5e-7),   # the seven-sphere world, 64x64
    "fuzzy": (0.001, 1e-5),     # glsl_world, fuzzy flags, 64x64
    "glsl": (0.0003, 2.5e-5),   # glsl_world, the main path's 512x512
    "frames": (0.001, 2.5e-5),  # the main path's 16-frame mean
}
RES = 512
PT_FRAMES = 16

# The card's peaks for the bound (H100 SXM datasheet, 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bad_fraction(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(fraction of pixels whose worst channel differs by more than ATOL,
    max abs difference); the criterion of tests/conftest.assert_images_close."""
    diff = (got.double() - want.double()).abs().amax(dim=-1)
    return float((diff > ATOL).double().mean()), float(diff.max())


def four_type_scene(res):
    """Triangle, reflective and glass spheres, plane and box, two lights."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef

    sd = SceneDef()
    sd.set_camera(eye=[0.5, 1.5, 6], at=[0, 0.3, 0], up=[0, 1, 0], fov=40,
                  hither=0.01, res_x=res, res_y=res, aperture_ratio=0,
                  focal_ratio=1)
    diffuse = sd.add_material([0.7, 0.7, 0.2], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    mirror = sd.add_material([0.1, 0.1, 0.1], 0.2, [0.9, 0.9, 0.9], 0.8, 200,
                             0, 1)
    glass = sd.add_material([0, 0, 0], 0.0, [1, 1, 1], 0.1, 100, 1, 1.5)
    sd.add_plane_points([0, -0.5, 0], [1, -0.5, 0], [0, -0.5, -1], diffuse)
    sd.add_sphere([-1.2, 0.3, 0], 0.8, mirror)
    sd.add_sphere([1.0, 0.2, 1.0], 0.7, glass)
    sd.add_triangle([-0.5, -0.4, 2.0], [0.5, -0.4, 2.0], [0, 0.7, 1.8],
                    diffuse)
    sd.add_box([-0.4, -0.5, -1.5], [0.6, 0.5, -0.6], mirror)
    sd.add_light([4, 6, 4], [1, 1, 1])
    sd.add_light([-5, 3, 2], [0.5, 0.4, 0.4])
    sd.bg_color = np.array([0.3, 0.5, 0.9], np.float32)
    return sd


def tiny_pt_world(device):
    """Every branch of the path-tracer kernel in 7 spheres + 2 triangles +
    2 lights: static and moving spheres, a negative-radius shell, all three
    scatter types, fuzzy metal, Beer's-law glass (tests/test_pt_megakernel.py
    ::tiny_world, rebuilt with the port's types)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pathtracer as pt,
    )

    f = np.float32

    def t(a, dtype=f):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    mats = pt.PTMaterials(
        mtype=t([pt.MT_DIFFUSE, pt.MT_DIFFUSE, pt.MT_METAL, pt.MT_METAL,
                 pt.MT_DIELECTRIC, pt.MT_DIELECTRIC, pt.MT_DIFFUSE],
                np.int32),
        albedo=t([[.6, .3, .2], [.2, .5, .7], [0, 0, 0], [0, 0, 0],
                  [1, 1, 1], [1, 1, 1], [.4, .4, .4]]),
        spec_color=t([[0] * 3, [0] * 3, [.8, .7, .6], [.9, .9, .9],
                      [.04] * 3, [.04] * 3, [0] * 3]),
        roughness=t([1, 1, 0, 0.4, 0, 0.2, 1]),
        ref_idx=t([1, 1, 1, 1, 1.5, 1.2, 1]),
        refract_color=t([[0] * 3] * 4 + [[0, 0, 0], [.3, .1, .6], [0] * 3]),
        emissive=t(np.zeros((7, 3))),
    )
    c0 = np.array([[-2, 0.5, 0], [0, 0.5, 0], [2, 0.5, 0], [-1, 0.5, -2],
                   [1, 0.5, -2], [1, 0.5, -2], [3, 0.5, -1]], f)
    c1 = c0.copy()
    c1[1] += [0, 0.4, 0]  # moving diffuse
    return pt.PTScene(
        sp_center0=t(c0), sp_center1=t(c1),
        sp_radius=t([0.5, 0.5, 0.5, 0.5, 0.5, -0.25, 0.5]),  # hollow shell
        sp_time0=t(np.zeros(7)), sp_time1=t(np.ones(7)),
        sp_mat=t([0, 1, 2, 3, 4, 5, 1], np.int32),
        tri_v0=t([[-8, 0, 8], [-8, 0, -8]]),
        tri_e1=t([[16, 0, 0], [16, 0, 16]]),
        tri_e2=t([[0, 0, -16], [16, 0, 0]]),
        tri_mat=t([6, 6], np.int32),
        materials=mats,
        light_pos=t([[-5, 8, 3], [5, 8, -3]]),
        light_color=t([[1, 1, 1], [.8, .8, 1]]),
    )


def pt_time_span(cam):
    """The camera with the path tracer's shutter [0, 1] (glsl_camera's)."""
    import dataclasses

    return dataclasses.replace(cam, time0=torch.zeros_like(cam.time0),
                               time1=torch.ones_like(cam.time1))


def pt_inputs(cam, cfg, seed, device):
    """(o, d, time, uni) of one path-tracer frame, drawn as
    make_render_frame draws them."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pathtracer as pt,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    rays = pt.camera_rays(cam, g)
    uni = pt.draw_uniforms(g, cfg.max_bounces, rays.origin.shape[0])
    return rays.origin, rays.direction, rays.time, uni


def pt_agreement(got: torch.Tensor, want: torch.Tensor):
    """(fraction of pixels beyond ATOL, mean abs difference, max abs
    difference) of two path-tracer images or color batches."""
    diff = (got.double() - want.double()).abs()
    return (float((diff.amax(dim=-1) > ATOL).double().mean()),
            float(diff.mean()), float(diff.max()))


def check_pt(label, got, want, limits):
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: kernel output is not finite")
    bad, mean, err = pt_agreement(got, want)
    max_bad, max_mean = limits
    print(f"compare {label}: {bad * 100:.4f}% pixels beyond {ATOL}, mean abs "
          f"diff {mean:.3g}, max abs diff {err:.3g}")
    if bad > max_bad or mean > max_mean:
        raise AssertionError(
            f"{label}: kernel and plain version disagree ({bad * 100:.4f}% "
            f"of pixels beyond {ATOL}, limit {max_bad * 100}%; mean "
            f"{mean:.3g}, limit {max_mean})")
    return bad, mean, err


def pt_cases(dev):
    """The path tracer's kernel-against-plain cases, as (label, limits,
    tables, (o, d, time, uni), cfg): the seven-sphere world at 64x64 under
    three configs, glsl_world with fuzzy reflection and refraction at 64x64,
    and glsl_world at the main path's 512x512, 10 bounces."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_camera,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pathtracer as pt,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pt_megakernel as ptk,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
        glsl_camera,
        glsl_world,
    )

    tiny_cam = pt_time_span(build_camera(dict(
        eye=[0.0, 2.0, 6.0], at=[0, 0.5, -1], up=[0, 1, 0], fov=60.0,
        hither=0.01, res_x=64, res_y=64, aperture_ratio=0.0,
        focal_ratio=1.0), device=dev))
    tiny = ptk.pt_tables(tiny_pt_world(dev))
    for i, (label, cfg) in enumerate((
            ("base, 3 bounces", pt.PTConfig(max_bounces=3)),
            ("russian roulette, 4 bounces",
             pt.PTConfig(max_bounces=4, russian_roulette=True)),
            ("reference_shadow_len1, 2 bounces",
             pt.PTConfig(max_bounces=2, reference_shadow_len1=True)))):
        yield (f"tiny world 64x64 {label}", PT_LIMITS["tiny"], tiny,
               pt_inputs(tiny_cam, cfg, 10 + i, dev), cfg)
    fuzzy = glsl_world(device=dev, showcase_fuzzy_reflections=True,
                       showcase_fuzzy_refractions=True)
    cfg = pt.PTConfig()
    yield ("glsl_world fuzzy reflection+refraction 64x64, 10 bounces",
           PT_LIMITS["fuzzy"], ptk.pt_tables(fuzzy),
           pt_inputs(glsl_camera(64, 64, device=dev), cfg, 13, dev), cfg)
    yield (f"glsl_world {RES}x{RES}, {cfg.max_bounces} bounces (main path "
           "shapes)", PT_LIMITS["glsl"], ptk.pt_tables(glsl_world(device=dev)),
           pt_inputs(glsl_camera(RES, RES, device=dev), cfg, 20, dev), cfg)


# Operations in the repo's per-test model (tools/device_validate.py:461): a
# closest-hit test costs 32 per sphere and 45 per triangle; a shadow
# feeler's test 30 per sphere and, where the kernels run it, 45 per
# triangle; 80 per hit and light; 120 per hit for the rest of its shading.
SPH_CLOSEST, SPH_ANY, TRI_TEST, PER_LIGHT, PER_HIT = 32, 30, 45, 80, 120


def work_flops(w, n_sph, n_tri):
    """Operations of the work ``w`` counted by whitted_work or pt_work."""
    return (w["tests"] * (SPH_CLOSEST * n_sph + TRI_TEST * n_tri)
            + w["hits"] * PER_HIT + w["pairs"] * PER_LIGHT
            + w["sph_tests"] * SPH_ANY + w["tri_tests"] * TRI_TEST)


def first_hit_tests(occ, sizes):
    """Primitive tests an any-hit walk runs over a table in order until it
    stops at its first hit. occ [F, N]: which primitives each of F feelers
    hits; sizes: the run of each primitive type in table order. Returns the
    tests per type."""
    if occ.shape[1] == 0:
        return [0] * len(sizes)
    stop = torch.where(occ.any(dim=1), occ.int().argmax(dim=1) + 1,
                       occ.shape[1])
    counts, start = [], 0
    for size in sizes:
        counts.append(int((stop - start).clamp(0, size).sum()))
        start += size
    return counts


def bound(flops, n_bytes):
    """(ms, "operations" or "bytes"): the least time the card could take for
    the work, at the f32 peak outside the tensor cores and at the memory
    rate."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_frames(label, frame, args_of, card, frames=20):
    """One frame's breakdown under torch.profiler over ``frames`` frames
    ``frame(*args_of(i))``: host wall time, device busy time (the union of
    the device's kernel and copy intervals), the device's idle share, device
    operations per frame and the busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    frame(*args_of(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(frames):
            frame(*args_of(i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        print(f"profile {label}: host wall {wall_ms:.4f} ms/frame; device "
              "time not measured (the profiler saw no device events)")
        return
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in device):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy_ms = busy_us / 1e3 / frames
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    print(f"profile {label} (profiler on, {frames} frames, {card}): host "
          f"wall {wall_ms:.4f} ms/frame, device busy {busy_ms:.4f} "
          f"ms/frame, device idle {100 * (1 - busy_ms / wall_ms):.1f}%, "
          f"{len(device) / frames:.1f} device ops/frame; busiest: "
          + "; ".join(f"{name[:90]} {us / 1e3 / frames:.4f} ms/frame"
                      for name, us in top))


def whitted_work(scene, o, d, cfg):
    """What the Whitted kernel computes on rays (o, d), counted on the
    sweep's levels (models/whitted): ``tests``, the nodes alive at each
    level, each a closest-hit test over every primitive; ``hits``, the nodes
    that hit and shade; ``pairs``, their (hit, light) pairs; ``feelers``,
    the pairs whose light faces the hit, each a shadow ray that tests
    triangles, then spheres, up to its first occluder (``tri_tests``,
    ``sph_tests``), as the kernel's walk does."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        Rays,
        dot,
        normalize,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import whitted
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    p = scene.prims
    if p.n_pl or p.n_box or cfg.soft_shadow:
        raise NotImplementedError("the work model counts triangles and "
                                  "spheres lit by point lights")
    present = (p.n_sph > 0, p.n_tri > 0, False, False)
    max_t = C.BIG if cfg.shadow_unbounded else 1.0
    rays = Rays.make(o, d)
    active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    ior = torch.ones(o.shape[0], dtype=o.dtype, device=o.device)
    w = dict(tests=0, hits=0, pairs=0, feelers=0, tri_tests=0, sph_tests=0)
    for lvl in range(cfg.max_depth):
        t_disc, obj_id = whitted.trace_closest(scene, rays)
        hit = active & (obj_id >= 0)
        w["tests"] += int(active.sum())
        w["hits"] += int(hit.sum())
        # the hit point and normal as whitted._level_step derives them
        params, ptype, _ = intersect.gather_prims(p, obj_id)
        t = intersect.per_ray_t(params, ptype, rays.origin, rays.direction,
                                present)
        t = torch.where(t >= C.BIG, t_disc, t)
        point = rays.origin + rays.direction * t[:, None]
        n = normalize(intersect.per_ray_normal(
            params, ptype, point, rays.origin, rays.direction, present))
        point, n = point[hit], n[hit]
        for li in range(scene.n_lights):
            to_light = scene.lights.position[li][None, :] - point
            facing = dot(to_light, n) > 0.0
            w["pairs"] += point.shape[0]
            w["feelers"] += int(facing.sum())
            occ = [tk < max_t for tk, _ in intersect._small_sweeps(
                p, (point + n * C.EPSILON)[facing], to_light[facing])]
            tri, sph = first_hit_tests(torch.stack(occ, dim=1),
                                       (p.n_tri, p.n_sph))
            w["tri_tests"] += tri
            w["sph_tests"] += sph
        if lvl == cfg.max_depth - 1:
            break
        _, (children, _) = whitted._level_step(scene, rays, active, ior, cfg,
                                               True)
        kids = [children[k] for k, on in (("refl", scene.has_reflective),
                                          ("refr", scene.has_transmissive))
                if on]
        if not kids:
            break
        rays = Rays(*(torch.cat([getattr(k[0], f) for k in kids])
                      for f in ("origin", "direction", "time")))
        active = torch.cat([k[1] for k in kids])
        ior = torch.cat([k[2] for k in kids])
    return w


def pt_work(scene, cfg, rays, uni):
    """What the path-tracer kernel computes on these inputs, counted by
    stepping its plain version (models/pathtracer._bounce): ``alive``, the
    paths alive at the start of each bounce, each a closest-hit test over
    every sphere and triangle (``tests`` in all); ``hits`` and
    ``hits_by_type`` (diffuse, metal, dielectric: a diffuse or metal hit
    reads 3 uniform rows, a dielectric 4, and under Russian roulette every
    hit one more); ``pairs``, the (hit, light) pairs; ``feelers``, the pairs
    that face the light, each a shadow feeler that tests spheres, then
    triangles, up to its first occluder (``sph_tests``, ``tri_tests``), as
    the kernel does."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        dot,
        normalize,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pathtracer as pt,
    )

    R = rays.origin.shape[0]
    sizes = (scene.sp_radius.shape[0], scene.tri_v0.shape[0])
    w = dict(alive=[], hits_by_type=[0, 0, 0], pairs=0, feelers=0,
             sph_tests=0, tri_tests=0)
    state = (rays, rays.origin.new_ones((R, 3)), rays.origin.new_zeros((R, 3)),
             torch.ones(R, dtype=torch.bool, device=rays.origin.device))
    for i in range(uni.shape[0]):
        r, active = state[0], state[3]
        n_alive = int(active.sum())
        if n_alive == 0:
            break
        w["alive"].append(n_alive)
        hit = pt.hit_world(scene, r)
        live = active & hit.hit
        mtype = scene.materials.mtype[hit.mat_id[live]]
        for k in range(3):
            w["hits_by_type"][k] += int((mtype == k).sum())
        point, n, time = hit.point[live], hit.normal[live], r.time[live]
        for li in range(scene.light_pos.shape[0]):
            to_light = scene.light_pos[li][None, :] - point
            ldir = normalize(to_light)
            facing = dot(n, ldir) > 0.0
            w["pairs"] += point.shape[0]
            w["feelers"] += int(facing.sum())
            fo, fd = (point + pt._EPS * n)[facing], ldir[facing]
            max_t = (torch.ones_like(fd[:, 0]) if cfg.reference_shadow_len1
                     else torch.linalg.vector_norm(to_light[facing], dim=-1))
            occ = torch.cat([
                pt._sphere_ts(scene, fo, fd, time[facing], max_t)[0],
                pt._triangle_ts(scene, fo, fd, max_t)], dim=1) < C.BIG
            sph, tri = first_hit_tests(occ, sizes)
            w["sph_tests"] += sph
            w["tri_tests"] += tri
        state = pt._bounce(scene, cfg, uni[i], state)
    w["tests"] = sum(w["alive"])
    w["hits"] = sum(w["hits_by_type"])
    return w


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        Rays,
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.image import save_png
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.kernels import build as kb
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pathtracer as pt,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pt_megakernel as ptk,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_megakernel as mk,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
        glsl_camera,
        glsl_world,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
        render_image,
        render_tile,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        pinhole_rays,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import checkpoint
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.timing import (
        cuda_ms,
        frame_ms,
        mpaths_per_s,
        mrays_per_s,
        pt_frame_ms,
    )

    t_start = time.perf_counter()
    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build, one nvcc per source, all started together
    names = ("whitted_megakernel", "pt_megakernel")

    def timed_build(name):
        t0 = time.perf_counter()
        lib = kb.build(name)
        return lib, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(timed_build, names)))
    for name in names:
        lib, secs = builds[name]
        print(f"build: {lib.name} in {secs:.1f} s")
        for line in kb.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. kernel against plain on the same rays
    def rays_of(scene, drift=0.0):
        cam = scene.camera
        px, py = pixel_grid(cam.res_x, cam.res_y, dev)
        r = pinhole_rays(cam, px + 0.5 + drift, py + 0.5)
        return r.origin.contiguous(), r.direction.contiguous()

    def compare(label, scene, cfg):
        o, d = rays_of(scene)
        shape = mk.shape_of(scene)
        tbl, lt, bg = mk.scene_tables(scene)
        got = kernels.whitted_megakernel(tbl, lt, bg, o, d, shape, cfg)
        want = mk.trace_rays_plain(shape, tbl, lt, bg, o, d, cfg)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: kernel output is not finite")
        bad, err = bad_fraction(got, want)
        print(f"compare {label}: {bad * 100:.3f}% pixels beyond {ATOL}, "
              f"max abs err {err:.3g}")
        if bad > MAX_BAD:
            raise AssertionError(
                f"{label}: kernel and plain version disagree on "
                f"{bad * 100:.2f}% of pixels (limit {MAX_BAD * 100}%)")
        return bad

    worst = 0.0
    mount64 = build_scene(scenes.mount_scene(res=64), device=dev)
    for fresnel in ("schlick", "reference_schlick", "reference_exact"):
        for refraction in ("reference", "physical"):
            for unbounded in (False, True):
                cfg = RenderConfig(fresnel_mode=fresnel,
                                   refraction_mode=refraction,
                                   shadow_unbounded=unbounded)
                worst = max(worst, compare(
                    f"mount64 {fresnel}/{refraction}/unbounded={unbounded}",
                    mount64, cfg))
    worst = max(worst, compare(
        "four-type 64", build_scene(four_type_scene(64), device=dev),
        RenderConfig()))
    worst = max(worst, compare(
        "four-type 64 soft-shadow grid",
        build_scene(four_type_scene(64), device=dev),
        RenderConfig(soft_shadow=True)))
    worst = max(worst, compare(
        "sphere_field n_side=8 64",
        build_scene(scenes.sphere_field_scene(n_side=8, res=64,
                                              accel=C.ACCEL_NONE),
                    device=dev),
        RenderConfig()))
    print(f"worst pixel fraction at 64x64: {worst * 100:.3f}%")

    scene = build_scene(scenes.mount_scene(res=RES), device=dev)
    cfg_mk = RenderConfig(engine="megakernel")
    cfg_sw = RenderConfig(engine="sweep")
    shape = mk.shape_of(scene)
    tbl, lt, bg = mk.scene_tables(scene)
    o, d = rays_of(scene)
    got = kernels.whitted_megakernel(tbl, lt, bg, o, d, shape, cfg_mk)
    want = mk.trace_rays_plain(shape, tbl, lt, bg, o, d, cfg_mk)
    torch.cuda.synchronize()
    bad512, max_abs_err = bad_fraction(got, want)
    print(f"compare mount{RES} (main path shapes): {bad512 * 100:.3f}% "
          f"pixels beyond {ATOL}, max abs err {max_abs_err:.3g}")
    if bad512 > MAX_BAD:
        raise AssertionError(f"kernel and plain version disagree at {RES}^2")

    # 4. main path through the entry points a user calls
    kernels.whitted_megakernel.launches = 0
    img = render_image(scene, cfg_mk)
    torch.cuda.synchronize()
    launches = kernels.whitted_megakernel.launches
    print(f"main path: render_image mount_low {RES}x{RES} depth "
          f"{cfg_mk.max_depth} engine=megakernel, kernel launches {launches}")
    if launches < 1:
        raise AssertionError("the main path did not launch the kernel")
    if img.shape != (RES, RES, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad image: {tuple(img.shape)}")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("image outside [0, 1]")
    plain_img = render_image(scene, cfg_sw)
    bad, err = bad_fraction(img, plain_img)
    print(f"main path against the plain sweep: {bad * 100:.3f}% pixels "
          f"beyond {ATOL}, max abs err {err:.3g}")
    if bad > MAX_BAD:
        raise AssertionError("main path image disagrees with the sweep")
    (ROOT / "build").mkdir(exist_ok=True)
    save_png(str(ROOT / "build" / "mount_smoke.png"), img)
    subprocess.run(
        [sys.executable, "-m", "u_4a_2s_p3d_raytracer_template2_tpu_torch.cli",
         "render", "--builtin", "mount", "--res", str(RES), "--engine",
         "megakernel", "-o", "build/mount.png"], cwd=ROOT, check=True)

    # 5. timing: the kernel and its plain version alone on drifting rays,
    # then whole frames of both engines
    inputs = [(tbl, lt, bg, *rays_of(scene, 0.37 * i), shape, cfg_mk)
              for i in range(21)]
    kernel_ms = cuda_ms(kernels.whitted_megakernel, inputs)
    plain_ms = cuda_ms(mk.trace_rays_plain,
                       [(shape, tbl, lt, bg, a[3], a[4], cfg_mk)
                        for a in inputs])
    print(f"kernel alone: {kernel_ms:.4f} ms; plain version alone: "
          f"{plain_ms:.4f} ms (mount_low {RES}x{RES} depth 4, {card})")
    for label, cfg in (("megakernel", cfg_mk), ("sweep", cfg_sw)):
        ms = frame_ms(scene, cfg)
        print(f"frame {label}: {ms:.4f} ms, {mrays_per_s(scene, ms):.2f} "
              f"Mrays/s (primary+shadow), mount_low {RES}x{RES} depth 4, "
              f"{card}")
    px, py = pixel_grid(RES, RES, dev)
    profile_frames(f"whitted frame, megakernel engine, mount_low {RES}x{RES}",
                   render_tile, lambda i: (scene, px + 0.37 * i, py, cfg_mk),
                   card)
    # the bound: this run's work (whitted_work) in operations, against the
    # rays in (24 B) and colors out (12 B) and the tables read once
    ww = whitted_work(scene, o, d, cfg_mk)
    w_flops = work_flops(ww, scene.prims.n_sph, scene.prims.n_tri)
    w_bytes = o.shape[0] * 36 + 4 * (tbl.numel() + lt.numel() + bg.numel())
    w_bound_ms, w_bound_by = bound(w_flops, w_bytes)
    print(f"whitted work: {ww['tests']} nodes ({ww['tests'] / o.shape[0]:.3f} "
          f"per ray), {ww['hits']} hits, {ww['pairs']} hit-light pairs, "
          f"{ww['feelers']} shadow rays testing {ww['tri_tests']} triangles "
          f"and {ww['sph_tests']} spheres; {w_flops / 1e9:.4f} GFLOP, "
          f"{w_bytes / 1e6:.4f} MB; bound {w_bound_ms:.5f} ms ({w_bound_by})")

    # 6. path tracer: kernel against plain on the same rays and uniforms
    t_pt = time.perf_counter()
    for label, limits, tables, args, cfg in pt_cases(dev):
        got = kernels.pt_megakernel(tables, *args, cfg)
        want = ptk.trace_rays_plain(tables, *args, cfg)
        torch.cuda.synchronize()
        _, _, pt_max_abs_err = check_pt(label, got, want, limits)

    world = glsl_world(device=dev)
    cam = glsl_camera(RES, RES, device=dev)
    pt_cfg = pt.PTConfig()
    tables = ptk.pt_tables(world)

    # 7. path-tracer main path through the entry points a user calls
    frame_fn = ptk.make_render_frame(world, cam, pt_cfg, "megakernel")
    kernels.pt_megakernel.launches = 0
    acc = pt.render_progressive(
        world, cam, pt_cfg, torch.Generator(device=dev).manual_seed(0),
        n_frames=PT_FRAMES, frame_fn=frame_fn)
    image = pt.to_image(acc)
    torch.cuda.synchronize()
    pt_launches = kernels.pt_megakernel.launches
    print(f"main path: render_progressive glsl_world {RES}x{RES}, "
          f"{pt_cfg.max_bounces} bounces, {PT_FRAMES} frames, "
          f"engine=megakernel, kernel launches {pt_launches}")
    if pt_launches != PT_FRAMES:
        raise AssertionError(f"the path tracer's main path launched the "
                             f"kernel {pt_launches} times, not {PT_FRAMES}")
    if float(acc.count) != PT_FRAMES:
        raise AssertionError(f"accumulated {float(acc.count)} frames")
    if image.shape != (RES, RES, 3) or not bool(torch.isfinite(image).all()):
        raise AssertionError(f"bad path-traced image: {tuple(image.shape)}")
    mean = float(image.mean())
    print(f"path-traced image mean {mean:.5f}")
    if not mean > 0.01:
        raise AssertionError(f"path-traced image mean {mean} <= 0.01")
    plain_acc = pt.render_progressive(
        world, cam, pt_cfg, torch.Generator(device=dev).manual_seed(0),
        n_frames=PT_FRAMES,
        frame_fn=ptk.make_render_frame(world, cam, pt_cfg, "plain"))
    check_pt(f"main path {PT_FRAMES}-frame mean against the plain engine",
             acc.sum_linear / PT_FRAMES, plain_acc.sum_linear / PT_FRAMES,
             PT_LIMITS["frames"])
    save_png(str(ROOT / "build" / "pt_smoke.png"), image)
    ck = ROOT / "build" / "pt_smoke_ckpt.npz"
    ck.unlink(missing_ok=True)
    for extra in ([], ["--resume", str(ck)]):
        out = subprocess.run(
            [sys.executable, "-m",
             "u_4a_2s_p3d_raytracer_template2_tpu_torch.cli", "pathtrace",
             "--res", str(RES), "--frames", "8", "--checkpoint", str(ck),
             "-o", "build/pt.png", *extra],
            cwd=ROOT, check=True, capture_output=True, text=True).stdout
        print("  cli: " + out.strip().replace("\n", "\n  cli: "))
    resumed = checkpoint.restore(str(ck), pt.make_accumulator(RES, RES,
                                                              device=dev))
    if "16 spp accumulated" not in out or float(resumed.count) != 16.0:
        raise AssertionError("the CLI's checkpoint and resume did not reach "
                             "16 spp")

    # 8. timing: kernel and plain version alone on distinct frames' inputs,
    # a whole megakernel frame; live bounces for the bound
    pt_inputs_list = [(tables, *pt_inputs(cam, pt_cfg, 100 + i, dev), pt_cfg)
                      for i in range(11)]
    pt_kernel_ms = cuda_ms(kernels.pt_megakernel, pt_inputs_list)
    pt_plain_ms = cuda_ms(ptk.trace_rays_plain, pt_inputs_list[:3],
                          warmup=1)
    pt_ms = pt_frame_ms(frame_fn, device=dev)
    print(f"path tracer: kernel alone {pt_kernel_ms:.4f} ms; plain version "
          f"alone {pt_plain_ms:.4f} ms; frame (megakernel) {pt_ms:.4f} ms, "
          f"{mpaths_per_s(RES, RES, pt_ms):.2f} Mpaths/s (glsl_world "
          f"{RES}x{RES}, {pt_cfg.max_bounces} bounces, {card})")
    profile_frames(
        f"path-tracer frame, megakernel engine, glsl_world {RES}x{RES}",
        frame_fn,
        lambda i: (torch.Generator(device=dev).manual_seed(2000 + i),), card)
    # the bound: this run's work (pt_work) in operations, against the rays
    # in (28 B), the uniform rows the hits read (4 B each), the color out
    # (12 B) and the tables read once
    o, d, tm, uni = pt_inputs_list[0][1:5]
    pw = pt_work(ptk.scene_from_tables(tables), pt_cfg, Rays(o, d, tm), uni)
    R = o.shape[0]
    diffuse, metal, dielectric = pw["hits_by_type"]
    uni_rows = (3 * (diffuse + metal) + 4 * dielectric
                + (pw["hits"] if pt_cfg.russian_roulette else 0))
    pt_flops = work_flops(pw, tables.n_sph, tables.n_tri)
    pt_bytes = (R * (28 + 12) + 4 * uni_rows
                + 4 * (tables.tbl.numel() + tables.lt.numel()))
    pt_bound_ms, pt_bound_by = bound(pt_flops, pt_bytes)
    print(f"path tracer work: alive per bounce {pw['alive']}; "
          f"{pw['tests'] / R:.4f} live bounces per path, {pw['hits'] / R:.4f} "
          f"hits per path (diffuse, metal, dielectric {pw['hits_by_type']}); "
          f"{pw['pairs']} hit-light pairs, {pw['feelers']} feelers testing "
          f"{pw['sph_tests']} spheres and {pw['tri_tests']} triangles; "
          f"{pt_flops / 1e9:.4f} GFLOP, {pt_bytes / 1e6:.4f} MB; bound "
          f"{pt_bound_ms:.5f} ms ({pt_bound_by})")
    print(f"path-tracer phases {time.perf_counter() - t_pt:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    src = "u_4a_2s_p3d_raytracer_template2_tpu_torch/csrc/"
    print(json.dumps({"kernels": [{
        "name": "whitted_megakernel",
        "route": "cuda",
        "source": src + "whitted_megakernel.cu",
        "replaces": "u_4a_2s_p3d_raytracer_template2_tpu/models/"
                    "whitted_megakernel.py:685",
        "also_replaces": "u_4a_2s_p3d_raytracer_template2_tpu/models/"
                         "whitted_streamed.py:353",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": w_bound_ms,
        "bound_by": w_bound_by,
        "library_ms": None,
    }, {
        "name": "pt_megakernel",
        "route": "cuda",
        "source": src + "pt_megakernel.cu",
        "replaces": "u_4a_2s_p3d_raytracer_template2_tpu/models/"
                    "pt_megakernel.py:535",
        "launches": pt_launches,
        "max_abs_err": pt_max_abs_err,
        "ms": pt_kernel_ms,
        "plain_ms": pt_plain_ms,
        "bound_ms": pt_bound_ms,
        "bound_by": pt_bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
