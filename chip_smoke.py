"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each raising on failure:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile csrc/whitted_megakernel.cu, csrc/pt_megakernel.cu,
     csrc/bvh_walk.cu, csrc/brute_intersect.cu and csrc/probes.cu with nvcc,
     one process each, started together; print the build times and ptxas's
     register and spill report.
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
  BVH path (the sphere field of 7,396 spheres, 512x512, depth 4, sweep):
  9. the walk's kernels (closest, any, fused multi-light any) against their
     plain version on the same rays under BVH_LIMITS (bvh_cases): the main
     path's primary rays, level-1 rays and shadow segments with their dead
     masks, the 18,496-sphere field's primary rays, and a soup of all four
     primitive types with incoherent and axis-parallel rays; the fused
     launch against one launch per light, exactly;
  10. main path: render_image of the field with the walk's launch counters
     reset just before and read just after; accel_impl="multi" gives the
     same image through the fused walk; at 128x128 the BVH image against
     brute force; the PNG; the CLI render command on the built-in sphere
     field and random scene with --accel 2;
  11. timing: each kernel alone on the main path's primary and level-1
     queries, as device time with the launches queued (utils/timing
     .queued_ms) and as CUDA-event time per call, its plain version, the
     bound from the kernel's own work counters, a whole frame and its
     breakdown under torch.profiler with the walk's share of device time.
  Brute-force path (the same field under ACCEL_NONE, 512x512, depth 4,
  sweep):
  12. the kernels (closest, any) against their plain version on the same
     rays under BRUTE_LIMITS (brute_cases), the plain version PLAIN_BATCH
     rays a call: the main path's primary rays, level-1 rays and shadow
     segments with their dead masks at max_t 1 and unbounded; the soup's
     triangles alone, spheres alone and both tables with incoherent rays,
     segments and axis-parallel rays; twinned primitives in shuffled rows,
     where only the tie rule decides;
  13. main path: render_image of the field with the launch counters reset
     just before and read just after (4 closest, 8 any-hit, no walk); the
     image against the BVH walk's of phase 10; the soup at 512x512 the same
     way; the PNGs; the CLI render command with --accel 0;
  14. timing: each kernel alone on the main path's primary and level-1
     queries and per table mix (the field's spheres alone, the soup's
     triangles alone), as device time with the launches queued, its plain
     version on one batch, the bound from the kernel's own work counters
     (its tests by where each ended, BRUTE_STAGE_OPS), whole frames and a
     frame's breakdown under torch.profiler with the kernels' share of
     device time. Each K4 entry of the kernels line gives the rays its "ms"
     and its "plain_ms" were timed on ("rays", "plain_rays").
  Device probes (csrc/probes.cu; the port's tools/ package):
  15. T2's f32 FMA stream against its plain version, its TFLOP/s beside the
     datasheet's 67 and the SM clock under load; T1's five instruction
     classes against their plain versions, in chain steps/s; each rate at
     most 1.05 x its class ceiling (tools/device_validate.class_ceiling);
     mount_low's per-ray op mix on the sweep and its mix-weighted floor
     beside K1's time and bound; T3's walk with its stack in shared memory
     and in a per-thread array, on the probe's 3-node tree and a seeded tree
     of the field's depth, equal to the oracle and the plain version
     exactly, and both placements timed. These are probes, not the main
     path: their counters read 0 across phase 4.
  Whitted distribution path (mount_low 512x512, spp 4, depth 4, jittered
  soft shadows, fuzzy reflection, a 6x2048x2048x3 u8 skybox):
  16. the Whitted kernel against its plain version on the same rays and
     stream rows under per-case limits (whitted_cases, WHITTED_LIMITS):
     mount_low at template depths 1-3 and 5-8, the diffuse-only,
     reflective-only and refractive-only trees, each distribution flag
     alone, the sky with a u8 and a float cubemap, all flags together at
     depth 4 and 8;
  17. main path: the cubemap made from a seed and written as six PNG faces,
     the scene built from them, render_image on the megakernel engine with
     the kernel's launch counter reset just before and read just after (one
     launch a subpixel, 16); the frame against the plain version on the same
     draws; the PNG; the CLI render command with --builtin mount_dist
     --soft-shadow --fuzzy-reflection --skybox;
  18. timing: the kernel a subpixel launch (queued) and the frame's 16
     launches (CUDA events), its plain version, the draws alone (ms and
     bytes), whole frames and their rate, the JAX tool's distribution
     section (tools.device_validate.distribution), a frame's breakdown under
     torch.profiler, and the bound from this plan's work (whitted_work on
     every subpixel: jittered feelers to their first occluder, fuzzy
     children, sky texels, and the stream rows the kernel reads).
On a card, brute-force queries of more than 48 primitives go through the
brute-force kernels, so the plain sweep that phase 3 holds the Whitted
kernel against runs them on its 66-primitive field, and phase 10's 128x128
brute force is them too; both comparisons stay sound, since phase 12 holds
the brute-force kernels against their own plain version.
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


# The four-type scene's pruned trees: (mirror Ks, glass Ks, glass T) of each
# material population; "both" spawns reflection and refraction children.
FOUR_TYPE_KINDS = {"both": (0.8, 0.1, 1.0), "diffuse-only": (0.0, 0.0, 0.0),
                   "reflective-only": (0.8, 0.5, 0.0),
                   "refractive-only": (0.0, 0.0, 1.0)}


def four_type_scene(res, kind="both", aperture_ratio=0.0):
    """Triangle, reflective and glass spheres, plane and box, two lights;
    ``kind`` (FOUR_TYPE_KINDS) prunes the recursion tree, and
    ``aperture_ratio`` opens the lens (pixels) for depth of field."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef

    mirror_ks, glass_ks, glass_t = FOUR_TYPE_KINDS[kind]
    sd = SceneDef()
    sd.set_camera(eye=[0.5, 1.5, 6], at=[0, 0.3, 0], up=[0, 1, 0], fov=40,
                  hither=0.01, res_x=res, res_y=res,
                  aperture_ratio=aperture_ratio, focal_ratio=1)
    diffuse = sd.add_material([0.7, 0.7, 0.2], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    mirror = sd.add_material([0.1, 0.1, 0.1], 0.2, [0.9, 0.9, 0.9], mirror_ks,
                             200, 0, 1)
    glass = sd.add_material([0, 0, 0], 0.0, [1, 1, 1], glass_ks, 100, glass_t,
                            1.5)
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


# The Whitted kernel against its plain version on the same rays and stream
# rows, per case: (share of pixels beyond ATOL, mean abs difference)
# allowed. Each limit lies between what the sound kernel reads and what
# chip_faults.py's planted Whitted faults read (H100 80GB HBM3, 700 W; the
# readings are in PERF.md): the sound kernel reads 0 pixels and a mean of
# at most 1.5e-8 in every case (3.5e-7 built with contraction); each fault
# reads 0.17% or more and a mean of 1.7e-4 or more in the cases that show
# it. On the 512x512 distribution frame the sound kernel reads 0.0122% and
# a mean of 3.3e-7, all of it where a reflected or refracted child misses
# into the 2048x2048 noisy cubemap and a direction an ulp off the plain
# version's picks the neighbouring texel: 0 pixels with the sky off or at
# depth 1, 0.0046% at depth 2, and with fuzzy reflection off still
# 0.0088% (chip_faults.py reads each). The frame's limit rejects the
# kernel built with contraction (2.63%) and five of the six faults (0.08%
# or more); the sixth, the y offset read from the x row, reads 0.0324% on
# the frame and is rejected at 64x64.
WHITTED_LIMITS = {
    "exact": (0.0005, 5e-6),    # deterministic trees, flat background
    "sampled": (0.0005, 1e-5),  # AA, DoF, motion blur, jitter, fuzz
    "sky": (0.0005, 1e-5),      # misses read the cubemap
    "frame": (0.0005, 1e-5),    # the 512x512 distribution frame
}
WHITTED_RES = 64
DIST_SKY = 2048       # its cubemap's side: the JAX tool's distribution frame


# whitted_cases' cases: (label, WHITTED_LIMITS key, scene (mount_low or a
# FOUR_TYPE_KINDS kind), cubemap (None, "u8" or "f32"), RenderConfig fields)
_AA = dict(anti_aliasing=True, spp=2)
_ALL = dict(_AA, depth_of_field=True, motion_blur=True, soft_shadow=True,
            fuzzy_reflection=True, use_skybox=True)
WHITTED_CASES = (
    [(f"mount_low depth {D}", "exact", "mount", None, dict(max_depth=D))
     for D in (1, 2, 3, 5, 6, 7, 8)]
    + [(f"four-type {kind}", "exact", kind, None, {})
       for kind in ("diffuse-only", "reflective-only", "refractive-only")]
    + [("four-type AA spp 2", "sampled", "both", None, _AA),
       ("four-type AA spp 2 reference_aa_div16", "sampled", "both", None,
        dict(_AA, reference_aa_div16=True)),
       ("four-type DoF", "sampled", "both", None, dict(depth_of_field=True)),
       ("four-type motion blur", "sampled", "both", None,
        dict(motion_blur=True)),
       ("four-type soft shadows under AA", "sampled", "both", None,
        dict(_AA, soft_shadow=True)),
       ("four-type fuzzy reflection", "sampled", "both", None,
        dict(fuzzy_reflection=True)),
       ("four-type sky u8", "sky", "both", "u8", dict(use_skybox=True)),
       ("four-type sky f32", "sky", "both", "f32", dict(use_skybox=True)),
       ("reflective-only fuzzy reflection", "sampled", "reflective-only",
        None, dict(fuzzy_reflection=True)),
       ("refractive-only soft shadows under AA", "sampled",
        "refractive-only", None, dict(_AA, soft_shadow=True)),
       ("four-type all flags, sky u8", "sky", "both", "u8", _ALL),
       ("four-type all flags, sky u8, depth 8", "sky", "both", "u8",
        dict(_ALL, max_depth=8))])


def synthetic_cubemap(dev, f32=False, size=32, seed=5):
    """A [6, size, size, 3] cubemap on ``dev``: scenes.synthetic_skybox's
    u8 faces, or those faces as f32 colors."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
        synthetic_skybox,
    )

    faces = torch.from_numpy(synthetic_skybox(size, seed)).to(dev)
    return faces.float() / 255.99 if f32 else faces


def whitted_cases(dev, only=None):
    """The Whitted kernel's kernel-against-plain cases at 64x64, as (label,
    limits, scene, cfg, draws): mount_low at every template depth but the
    main path's 4; the four-type scene's three pruned trees; each
    distribution flag alone on the four-type scene (both branches, two
    lights, a plane and a box) at depth 4; the sky with a u8 and a float
    cubemap; fuzzy reflection on the reflective-only chain and jittered
    soft shadows on the refractive-only chain; all flags together at depth
    4 and 8. ``only``: the label of the one case to make."""
    import dataclasses

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import samples
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
        mount_scene,
    )

    res = WHITTED_RES
    for i, (label, limits, kind, sky, kw) in enumerate(WHITTED_CASES):
        if only is not None and label != only:
            continue
        sd = (mount_scene(res) if kind == "mount"
              else four_type_scene(res, kind, aperture_ratio=4.0))
        scene = build_scene(sd, device=dev)
        if sky is not None:
            scene = dataclasses.replace(
                scene, skybox=synthetic_cubemap(dev, f32=sky == "f32"),
                has_skybox=True)
        cfg = RenderConfig(engine="megakernel", **kw)
        layout = samples.scene_layout(scene, cfg)
        draws = samples.draw_plan(
            torch.Generator(device=dev).manual_seed(30 + i), layout, cfg,
            res * res)
        yield label, WHITTED_LIMITS[limits], scene, cfg, draws


def whitted_plain_trace(scene, rays, cfg, rows, offsets):
    """The kernel's plain version as a render_samples trace."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_megakernel as mk,
    )

    tbl, lt, bg = mk.scene_tables(scene)
    return mk.trace_rays_plain(mk.shape_of(scene), tbl, lt, bg, rays.origin,
                               rays.direction, cfg, rows,
                               mk.sky_of(scene, cfg), offsets)


def whitted_run(scene, cfg, draws, kernel=True):
    """[R, 3] colors of the scene's whole frame from ``draws``, through the
    kernel (models/whitted_megakernel.trace_rays_megakernel) or its plain
    version."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_megakernel as mk,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
        render_samples,
    )

    cam = scene.camera
    px, py = pixel_grid(cam.res_x, cam.res_y, scene.device)
    trace = mk.trace_rays_megakernel if kernel else whitted_plain_trace
    return render_samples(scene, px, py, cfg, trace, draws=draws)


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


# Distribution mode adds, counted from csrc/whitted_megakernel.cu: a
# jittered light offset 6 per (hit, light) pair; a fuzzy child 40 (the
# unit-sphere transform, the perturbed direction's normalize and its
# hemisphere test); a sky lookup 20 per miss.
PER_JITTER, PER_FUZZY, PER_SKY = 6, 40, 20


def work_flops(w, n_sph, n_tri):
    """Operations of the work ``w`` counted by whitted_work or pt_work."""
    return (w["tests"] * (SPH_CLOSEST * n_sph + TRI_TEST * n_tri)
            + w["hits"] * PER_HIT + w["pairs"] * PER_LIGHT
            + w["sph_tests"] * SPH_ANY + w["tri_tests"] * TRI_TEST
            + w.get("jitters", 0) * PER_JITTER
            + w.get("fuzzy", 0) * PER_FUZZY + w.get("sky", 0) * PER_SKY)


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


def profile_frames(label, frame, args_of, card, frames=20, share_of=()):
    """One frame's breakdown under torch.profiler over ``frames`` frames
    ``frame(*args_of(i))``: host wall time, device busy time (the union of
    the device's kernel and copy intervals), the device's idle share, device
    operations per frame and the busiest kernels; with ``share_of``, the
    device time of the kernels whose names hold one of those strings, and
    its share of the busy time."""
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
    if share_of:
        ms = sum(us for name, us in by_name.items()
                 if any(s in name for s in share_of)) / 1e3 / frames
        print(f"profile {label}: kernels named {'/'.join(share_of)} "
              f"{ms:.4f} ms/frame, {100 * ms / busy_ms:.1f}% of device busy")


def whitted_work(scene, o, d, cfg, rows=None, offsets=None):
    """What the Whitted kernel computes on rays (o, d) with the stream rows
    ``rows`` of the subpixel ``offsets``, counted on the sweep's levels
    (models/whitted): ``tests``, the nodes alive at each level, each a
    closest-hit test over every primitive; ``hits``, the nodes that hit and
    shade; ``pairs``, their (hit, light) pairs; ``feelers``, the pairs whose
    light (jittered under AA soft shadows) faces the hit, each a shadow ray
    that tests triangles, then spheres, up to its first occluder
    (``tri_tests``, ``sph_tests``), as the kernel's walk does; ``jitters``,
    the pairs that read a jittered light offset (2 rows each); ``fuzzy``,
    the reflection children perturbed by fuzzy reflection (3 rows each);
    ``misses``, the nodes that miss, and ``sky``, those of them that read a
    texel."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        Rays,
        dot,
        normalize,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        samples,
        whitted,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    p = scene.prims
    if p.n_pl or p.n_box or (cfg.soft_shadow and not cfg.anti_aliasing):
        raise NotImplementedError("the work model counts triangles and "
                                  "spheres lit by point lights")
    present = (p.n_sph > 0, p.n_tri > 0, False, False)
    max_t = C.BIG if cfg.shadow_unbounded else 1.0
    layout = samples.scene_layout(scene, cfg)
    vals = (samples.stream_rows(rows, layout, offsets, cfg.spp)
            if layout.n_rows else None)
    sky = cfg.use_skybox and scene.has_skybox
    rays = Rays.make(o, d)
    active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    ior = torch.ones(o.shape[0], dtype=o.dtype, device=o.device)
    w = dict(tests=0, hits=0, pairs=0, feelers=0, tri_tests=0, sph_tests=0,
             jitters=0, fuzzy=0, misses=0, sky=0)
    for lvl in range(layout.shape.n_levels):
        t_disc, obj_id = whitted.trace_closest(scene, rays)
        hit = active & (obj_id >= 0)
        w["tests"] += int(active.sum())
        w["hits"] += int(hit.sum())
        w["misses"] += int((active & (obj_id < 0)).sum())
        # the hit point and normal as whitted._level_step derives them
        params, ptype, mat_id = intersect.gather_prims(p, obj_id)
        t = intersect.per_ray_t(params, ptype, rays.origin, rays.direction,
                                present)
        t = torch.where(t >= C.BIG, t_disc, t)
        point = rays.origin + rays.direction * t[:, None]
        n = normalize(intersect.per_ray_normal(
            params, ptype, point, rays.origin, rays.direction, present))
        point, n = point[hit], n[hit]
        for li in range(scene.n_lights):
            lpos = scene.lights.position[li][None, :]
            if layout.soft_jit:
                jx, jy = (layout.level_values(vals, lvl, 2 * li + k)[hit]
                          for k in range(2))
                lpos = lpos + torch.stack([jx, jy, torch.zeros_like(jx)],
                                          dim=-1)
                w["jitters"] += point.shape[0]
            to_light = lpos - point
            facing = dot(to_light, n) > 0.0
            w["pairs"] += point.shape[0]
            w["feelers"] += int(facing.sum())
            occ = [tk < max_t for tk, _ in intersect._small_sweeps(
                p, (point + n * C.EPSILON)[facing], to_light[facing])]
            tri, sph = first_hit_tests(torch.stack(occ, dim=1),
                                       (p.n_tri, p.n_sph))
            w["tri_tests"] += tri
            w["sph_tests"] += sph
        if lvl == layout.shape.n_levels - 1:
            break
        if layout.has_fuzzy(lvl):
            ks = scene.materials.ks[mat_id.long()]
            w["fuzzy"] += int((hit & (ks > 0.0)).sum())
        _, (children, _) = whitted._level_step(scene, rays, active, ior, cfg,
                                               True, lvl, layout, vals)
        kids = [children[k] for k, on in (("refl", scene.has_reflective),
                                          ("refr", scene.has_transmissive))
                if on]
        if not kids:
            break

        def merge(part):
            # the sweep's slot order (slot = ray * W + path), which the
            # rows' level_values read
            parts = [part(k) for k in kids]
            return whitted._interleave(*parts) if len(parts) == 2 else parts[0]

        rays = Rays(merge(lambda k: k[0].origin),
                    merge(lambda k: k[0].direction),
                    merge(lambda k: k[0].time))
        active = merge(lambda k: k[1])
        ior = merge(lambda k: k[2])
    if sky:
        w["sky"] = w["misses"]
    return w


def add_work(total, w):
    """``total`` plus the counts of ``w``, key by key."""
    return {k: total.get(k, 0) + v for k, v in w.items()}


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


# ---------------------------------------------------------------------------
# the BVH walk (csrc/bvh_walk.cu)

# The walk's kernels against their plain version on the same rays, per case:
# the share of rays whose closest-hit ids differ, the largest t difference
# relative to max(t, 1) where they agree, and the share of occlusion results
# that differ. The kernel is built without multiply-add contraction
# (kernels/build.py), so its f32 operations are the plain version's one for
# one and the sound kernel reads 0 on all three.
BVH_LIMITS = {"ids": 1e-4, "t_rel": 1e-5, "occ": 1e-4}
# Operations per test in the walk's bound: a node's slab test about 20; a
# plane about 12 and a box about 30, beside the per-test model above
NODE_TEST, PLANE_TEST, BOX_TEST = 20, 12, 30
FIELD_SIDE = 86    # the main scene: 7,396 spheres (the balls_high class)
BIG_SIDE = 136     # 18,496 spheres: a tree of more than 16 leaves (K5a)


def camera_rays(scene, drift=0.0):
    """Contiguous (o, d) of a scene's primary rays, the pixel grid moved
    ``drift`` pixels along x."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        pinhole_rays,
    )

    cam = scene.camera
    px, py = pixel_grid(cam.res_x, cam.res_y, scene.device)
    r = pinhole_rays(cam, px + 0.5 + drift, py + 0.5)
    return r.origin.contiguous(), r.direction.contiguous()


def main_path_queries(scene, rays, active, ior, cfg):
    """One level of the main path below its closest hits: one
    models/whitted._level_step on ``rays``, with the shadow queries it hands
    to the walk or to brute force recorded as (origin, segment, max_t,
    dead), one per light. Returns (queries, children) where children is the
    next level's (rays, active, ior), reflection slots first."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        samples,
        whitted,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    queries = []
    walk, brute = packets.packet_any_hit, intersect.any_hit_brute

    def record(fn):
        def recorded(tables, r, max_t, dead=None, *rest):
            queries.append((r.origin.contiguous(), r.direction.contiguous(),
                            float(max_t), dead))
            return fn(tables, r, max_t, dead, *rest)
        return recorded

    packets.packet_any_hit = record(walk)
    intersect.any_hit_brute = record(brute)
    try:
        _, (children, _) = whitted._level_step(
            scene, rays, active, ior, cfg, True, 0,
            samples.scene_layout(scene, cfg), None)
    finally:
        packets.packet_any_hit = walk
        intersect.any_hit_brute = brute
    kids = [children["refl"], children["refr"]]
    return queries, (
        Rays(*(torch.cat([getattr(k[0], f) for k in kids]).contiguous()
               for f in ("origin", "direction", "time"))),
        torch.cat([k[1] for k in kids]), torch.cat([k[2] for k in kids]))


def soup_scene(n_tri=2000, n_sph=2000, seed=0, res=64):
    """tests/test_packets.py::soup at 2,000 triangles and 2,000 spheres in a
    10-unit cube, with a plane at y = -8, a box at the cube's corner and
    two lights, at res x res; BVH."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef

    rng = np.random.default_rng(seed)
    sd = SceneDef()
    sd.accel_type = C.ACCEL_BVH
    sd.set_camera(eye=[0, 0, 12], at=[0, 0, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=res, res_y=res, aperture_ratio=0,
                  focal_ratio=1)
    m = sd.add_material([0.7, 0.7, 0.7], 1.0, [1, 1, 1], 0.1, 20, 0, 1)
    for _ in range(n_sph):
        sd.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.1, 0.5), m)
    for _ in range(n_tri):
        base = rng.uniform(-5, 5, 3)
        sd.add_triangle(base, base + rng.uniform(-0.8, 0.8, 3),
                        base + rng.uniform(-0.8, 0.8, 3), m)
    sd.add_plane_points([0, -8, 0], [1, -8, 0], [0, -8, 1], m)
    sd.add_box([-6, -6, -6], [-5.2, -5.2, -5.2], m)
    sd.add_light([10, 10, 10], [1, 1, 1])
    sd.add_light([-10, 8, 5], [1, 1, 1])
    return sd


def bvh_cases(dev):
    """The walk's kernel-against-plain cases as (label, tables, query,
    args); query "closest" takes (o, d), "any" (o, d, max_t, dead) and
    "multi" (o, dirs [L, R, 3], max_t, dead [L, R]). The main scene at
    512x512: its primary rays, its level-1 reflection and refraction rays,
    and its shadow segments at the primary hits with their dead masks, per
    light and fused over both, at max_t 1 (the main path's) and unbounded;
    the 18,496-sphere field's primary rays; a soup of 2,000 triangles,
    2,000 spheres, a plane and a box with incoherent rays and segments, and
    axis-parallel rays started on the box's face."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        Rays,
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes

    field = build_scene(scenes.sphere_field_scene(n_side=FIELD_SIDE,
                                                  res=RES), device=dev)
    tag = f"field{FIELD_SIDE} {RES}x{RES}"
    o, d = camera_rays(field)
    yield f"{tag} primary rays", field.packets, "closest", (o, d)
    R = o.shape[0]
    queries, (kids, _, _) = main_path_queries(
        field, Rays.make(o, d), torch.ones(R, dtype=torch.bool, device=dev),
        torch.ones(R, device=dev), RenderConfig())
    yield (f"{tag} level-1 reflection and refraction rays", field.packets,
           "closest", (kids.origin, kids.direction))
    for max_t in (1.0, C.BIG):
        for li, (so, sd, _, dead) in enumerate(queries):
            yield (f"{tag} shadow segments, light {li}, max_t {max_t:g}",
                   field.packets, "any", (so, sd, max_t, dead))
        yield (f"{tag} shadow segments of both lights fused, max_t "
               f"{max_t:g}", field.packets, "multi",
               (queries[0][0], torch.stack([q[1] for q in queries]), max_t,
                torch.stack([q[3] for q in queries])))
    del field, queries, kids

    big = build_scene(scenes.sphere_field_scene(n_side=BIG_SIDE, res=RES),
                      device=dev)
    yield (f"field{BIG_SIDE} {RES}x{RES} primary rays", big.packets,
           "closest", camera_rays(big))
    del big

    soup = build_scene(soup_scene(), device=dev).packets
    rng = np.random.default_rng(1)
    n = 65536

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    o = rng.uniform(-8, 8, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = t(o), t(d)
    yield "soup incoherent rays", soup, "closest", (o, d)
    segs = t(rng.uniform(-8, 8, (2, n, 3))) - o  # unnormalized, to points
    dead = t(rng.uniform(size=(2, n)) < 0.3, torch.bool)
    for max_t in (1.0, C.BIG):
        for i in range(2):
            yield (f"soup segments {i}, max_t {max_t:g}", soup, "any",
                   (o, segs[i], max_t, dead[i]))
        yield (f"soup segments fused, max_t {max_t:g}", soup, "multi",
               (o, segs, max_t, dead))
    # rays in the box's x = -6 face moving along y or z, as the sweep's
    # inactive slots move along z: only the safe inverse keeps their slab
    # tests free of 0 * inf
    m = 4096
    o = np.stack([np.full(m, -6.0), rng.uniform(-7, -4, m),
                  rng.uniform(-6.5, -4.7, m)], 1)
    d = np.zeros((m, 3))
    d[np.arange(m), rng.integers(1, 3, m)] = rng.choice([-1.0, 1.0], m)
    o, d = t(o), t(d)
    yield "soup axis-parallel rays in a box face", soup, "closest", (o, d)
    yield ("soup axis-parallel segments in a box face, max_t 1e+30", soup,
           "any", (o, d * 3.0, C.BIG, None))


def bvh_run(query, tables, args, kernel=True):
    """One case's answer from the kernel or from its plain version."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets

    if query == "closest":
        fn = kernels.bvh_closest if kernel else packets.closest_hit_plain
        return fn(tables, *args)
    if query == "any":
        fn = kernels.bvh_any if kernel else packets.any_hit_plain
        return fn(tables, *args)
    if kernel:
        return kernels.bvh_any_multi(tables, *args)
    o, dirs, max_t, dead = args
    return torch.stack([packets.any_hit_plain(tables, o, dirs[i], max_t,
                                              dead[i])
                        for i in range(dirs.shape[0])])


def hit_agreement(query, got, want):
    """Readings of a kernel's answer against the plain version's: closest
    hits {"ids": share of rays whose ids differ, "t_rel": largest t
    difference relative to max(t, 1) where they agree, "err": largest abs t
    difference there}; occlusion {"occ": share that differs, "err": 1.0 if
    any does}."""
    if query == "closest":
        (t, obj), (tp, objp) = got, want
        hit = (obj == objp) & (objp >= 0)
        dt = (t - tp).abs()[hit]
        return {"ids": float((obj != objp).double().mean()),
                "t_rel": float((dt / tp[hit].abs().clamp(min=1.0)).max())
                if dt.numel() else 0.0,
                "err": float(dt.max()) if dt.numel() else 0.0}
    diff = got != want
    return {"occ": float(diff.double().mean()), "err": float(diff.any())}


def rejects(reading, limits):
    """The limits of ``limits`` (BVH_LIMITS, BRUTE_LIMITS) that ``reading``
    breaks."""
    return [k for k, limit in limits.items() if reading.get(k, 0.0) > limit]


def bvh_work(query, tables, args):
    """(GFLOP, MB, bound ms, bound by) of one launch on ``args``, from the
    work the kernel's own walk counts: node box tests and primitive tests
    per type (its per-ray counters), against rays in, results out and the
    tables once."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels

    o = args[0]
    R = o.shape[0]
    counts = torch.zeros((R, kernels.WORK_COUNTS), dtype=torch.int32,
                         device=o.device)
    fn = {"closest": kernels.bvh_closest, "any": kernels.bvh_any,
          "multi": kernels.bvh_any_multi}[query]
    fn(tables, *args, counts=counts)
    nodes, tris, sphs, planes, boxes = counts.sum(dim=0, dtype=torch.int64
                                                  ).tolist()
    flops = (nodes * NODE_TEST + tris * TRI_TEST + planes * PLANE_TEST
             + boxes * BOX_TEST
             + sphs * (SPH_CLOSEST if query == "closest" else SPH_ANY))
    n_bytes = 4 * sum(t.numel() for t in (tables.nodes, tables.rows,
                                          tables.planes))
    if query == "closest":
        n_bytes += R * (24 + 8)           # o, d in; t, id out
    else:
        sets = args[1].shape[0] if query == "multi" else 1
        n_bytes += R * 12 + sets * R * (12 + 1 + 1)  # o; d, dead in; occ
    ms, by = bound(flops, n_bytes)
    print(f"  work: {nodes / R:.3f} node tests, {tris / R:.3f} triangle, "
          f"{sphs / R:.3f} sphere, {planes / R:.3f} plane and {boxes / R:.3f} "
          f"box tests per ray; {flops / 1e9:.4f} GFLOP, {n_bytes / 1e6:.4f} "
          f"MB; bound {ms:.5f} ms ({by})")
    return flops, n_bytes, ms, by


# ---------------------------------------------------------------------------
# the brute-force kernels (csrc/brute_intersect.cu)

# The brute-force kernels against their plain version on the same rays,
# per case: the readings of hit_agreement, with BVH_LIMITS' values. The
# kernels are built without multiply-add contraction, so the sound kernels
# read 0 on all three (chip_faults.py plants faults that they reject).
BRUTE_LIMITS = {"ids": 1e-4, "t_rel": 1e-5, "occ": 1e-4}
# Rays per call of the plain version on the card: its [R, 2048]
# temporaries take 268 MB each at this size; a whole 512x512 level at once
# would need tens of GB.
PLAIN_BATCH = 32768
# Operations of one brute-force test by where it ended, in the kernels'
# counter order (kernels.BRUTE_COUNTS): a triangle test at the det gate,
# the u gate, the v gate, with its t; a sphere test at the discriminant,
# with its roots. Counted from csrc/prim_tests.cuh, each add, subtract,
# multiply, divide, square root, min, max and compare one operation
# (negation, abs and selects none): 15, 27, 45 and 52 for a triangle, 20
# and 30 for a sphere, plus the one compare that folds the test's t into
# the ray's answer (t < kBig in a closest hit, t < max_t in an any hit).
BRUTE_STAGE_OPS = (16, 28, 46, 53, 21, 31)


def tie_scene(n=256, seed=3):
    """``n`` random spheres and ``n`` random triangles, each added twice,
    so that a ray that hits one hits its twin at the same t; and the unit
    sphere at the origin under a triangle in z = 1 that a ray down the z
    axis meets at the same t (4 from z = 5)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef

    rng = np.random.default_rng(seed)
    sd = SceneDef()
    sd.accel_type = C.ACCEL_NONE
    sd.set_camera(eye=[0, 0, 12], at=[0, 0, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=16, res_y=16, aperture_ratio=0,
                  focal_ratio=1)
    m = sd.add_material([0.7, 0.7, 0.7], 1.0, [1, 1, 1], 0.1, 20, 0, 1)
    for _ in range(n):
        c, r = rng.uniform(-6, 6, 3), rng.uniform(0.1, 0.5)
        sd.add_sphere(c, r, m)
        sd.add_sphere(c, r, m)
    for _ in range(n):
        base = rng.uniform(-6, 6, 3)
        tri = (base, base + rng.uniform(-0.8, 0.8, 3),
               base + rng.uniform(-0.8, 0.8, 3))
        sd.add_triangle(*tri, m)
        sd.add_triangle(*tri, m)
    sd.add_sphere([0, 0, 0], 1.0, m)
    sd.add_triangle([-2, -2, 1], [2, -2, 1], [0, 2, 1], m)
    sd.add_light([10, 10, 10], [1, 1, 1])
    return sd


def subset(prims, tri=True, sph=True):
    """``prims`` with only its triangles, only its spheres, or both: the
    plain version's view of a kernel table of those types."""
    import dataclasses

    return dataclasses.replace(prims, n_tri=prims.n_tri if tri else 0,
                               n_sph=prims.n_sph if sph else 0, n_pl=0,
                               n_box=0)


def brute_cases(dev):
    """The brute-force kernels' kernel-against-plain cases as (label,
    prims, tables, query, args): the plain version reads ``prims``, the
    kernel ``tables``; query "closest" takes (o, d), "any" (o, d, max_t,
    dead). The main scene under ACCEL_NONE at 512x512: its primary rays,
    its level-1 reflection and refraction rays, and its shadow segments at
    the primary hits with their dead masks, at max_t 1 (the main path's)
    and unbounded. The soup of 2,000 triangles and 2,000 spheres with
    incoherent rays and segments (30% dead) through its triangles alone
    (K4e, K4d), its spheres alone (K4a, K4c) and both (K4b), and
    axis-parallel rays; tie_scene's rays aimed at twinned primitives and
    down the z axis, with the kernel's rows in a random order."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        Rays,
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    field = build_scene(scenes.sphere_field_scene(
        n_side=FIELD_SIDE, res=RES, accel=C.ACCEL_NONE), device=dev)
    tables = intersect.brute_tables(field.prims)
    tag = f"field{FIELD_SIDE} brute {RES}x{RES}"
    o, d = camera_rays(field)
    yield f"{tag} primary rays", field.prims, tables, "closest", (o, d)
    R = o.shape[0]
    queries, (kids, _, _) = main_path_queries(
        field, Rays.make(o, d), torch.ones(R, dtype=torch.bool, device=dev),
        torch.ones(R, device=dev), RenderConfig())
    yield (f"{tag} level-1 reflection and refraction rays", field.prims,
           tables, "closest", (kids.origin, kids.direction))
    for max_t in (1.0, C.BIG):
        for li, (so, sd, _, dead) in enumerate(queries):
            yield (f"{tag} shadow segments, light {li}, max_t {max_t:g}",
                   field.prims, tables, "any", (so, sd, max_t, dead))
    del field, queries, kids

    soup = build_scene(soup_scene(), device=dev, accel=C.ACCEL_NONE).prims
    rng = np.random.default_rng(2)
    n = 65536

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    o = rng.uniform(-8, 8, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = t(o), t(d)
    segs = t(rng.uniform(-8, 8, (n, 3))) - o  # unnormalized, to points
    dead = t(rng.uniform(size=n) < 0.3, torch.bool)
    for label, tri, sph in (("triangles", True, False),
                            ("spheres", False, True),
                            ("triangles and spheres", True, True)):
        part = subset(soup, tri, sph)
        tb = intersect.brute_tables(part)
        yield f"soup {label}, incoherent rays", part, tb, "closest", (o, d)
        for max_t in (1.0, C.BIG):
            yield (f"soup {label}, segments, max_t {max_t:g}", part, tb,
                   "any", (o, segs, max_t, dead))
    # rays along the axes, as the sweep's inactive slots move along z
    m = 4096
    ax = np.zeros((m, 3))
    ax[np.arange(m), rng.integers(0, 3, m)] = rng.choice([-1.0, 1.0], m)
    ax_o = t(rng.uniform(-6, 6, (m, 3)))
    both = subset(soup)
    tb = intersect.brute_tables(both)
    yield ("soup triangles and spheres, axis-parallel rays", both, tb,
           "closest", (ax_o, t(ax)))
    yield ("soup triangles and spheres, axis-parallel segments, max_t 1",
           both, tb, "any", (ax_o, t(ax * 3.0), 1.0, None))
    del soup, both

    ties = build_scene(tie_scene(), device=dev).prims
    tb = intersect.brute_tables(ties)
    g = torch.Generator(device="cpu").manual_seed(4)
    ps = torch.randperm(tb.n_sph, generator=g).to(dev)
    pt = torch.randperm(tb.n_tri, generator=g).to(dev)
    shuffled = intersect.BruteTables(
        tb.sph[ps].contiguous(), tb.sph_ids[ps].contiguous(),
        tb.tri[pt].contiguous(), tb.n_sph, tb.n_tri)
    p = ties.params[:ties.n_sph + ties.n_tri]
    kind = ties.ptype[:p.shape[0]]
    sph_c = p[kind == C.SPHERE][:, 0:3]
    tri = p[kind == C.TRIANGLE]
    tri_c = tri[:, 0:3] + (tri[:, 3:6] + tri[:, 6:9]) / 3.0
    k = torch.arange(4096, device=dev)
    aims = torch.cat([sph_c[k % sph_c.shape[0]], tri_c[k % tri_c.shape[0]],
                      torch.zeros(64, 3, device=dev)])
    o = torch.cat([t(rng.uniform(-8, 8, (2 * 4096, 3))),
                   t([[0.0, 0.0, 5.0]] * 64)])
    seg = (aims - o) * 1.1  # just past the aimed primitive
    d = torch.nn.functional.normalize(seg, dim=-1).contiguous()
    yield ("twinned primitives, rows shuffled, aimed rays", ties, shuffled,
           "closest", (o, d))
    yield ("twinned primitives, rows shuffled, aimed segments, max_t 1",
           ties, shuffled, "any", (o, seg.contiguous(), 1.0, None))


def brute_run(query, tables, args, **kw):
    """One case's answer from the kernel."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels

    fn = kernels.brute_closest if query == "closest" else kernels.brute_any
    return fn(tables, *args, **kw)


def brute_plain(query, prims, args, batch=PLAIN_BATCH):
    """One case's answer from the plain version, ``batch`` rays a call."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    o, d = args[0], args[1]
    parts = []
    for s in range(0, o.shape[0], batch):
        rays = Rays.make(o[s:s + batch], d[s:s + batch])
        if query == "closest":
            parts.append(intersect.closest_hit_plain(prims, rays))
        else:
            dead = args[3]
            parts.append(intersect.any_hit_plain(
                prims, rays, args[2],
                None if dead is None else dead[s:s + batch]))
    if query == "closest":
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    return torch.cat(parts)


def brute_work(query, tables, args):
    """(GFLOP, MB, bound ms, bound by) of one launch on ``args``, from the
    tests the kernel's own counters record by where each ended (every ray
    tests every row in a closest hit; an any hit stops at its first
    occluder, dead lanes test nothing), each charged BRUTE_STAGE_OPS,
    against rays in, results out and the tables once."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels

    o = args[0]
    R = o.shape[0]
    counts = torch.zeros((R, kernels.BRUTE_COUNTS), dtype=torch.int32,
                         device=o.device)
    brute_run(query, tables, args, counts=counts)
    stages = counts.sum(dim=0, dtype=torch.int64).tolist()
    flops = sum(n * ops for n, ops in zip(stages, BRUTE_STAGE_OPS))
    tris, sphs = sum(stages[:4]), sum(stages[4:])
    n_bytes = 20 * tables.n_sph + 48 * tables.n_tri
    if query == "closest":
        n_bytes += R * (24 + 8)            # o, d in; t, id out
    else:
        n_bytes += R * (24 + 1 + (args[3] is not None))  # o, d, dead; occ
    ms, by = bound(flops, n_bytes)
    print(f"  work: {tris / R:.3f} triangle tests per ray (ended at det "
          f"{stages[0] / R:.3f}, u {stages[1] / R:.3f}, v {stages[2] / R:.3f}"
          f", with t {stages[3] / R:.3f}), {sphs / R:.3f} sphere tests (at "
          f"the discriminant {stages[4] / R:.3f}, with roots "
          f"{stages[5] / R:.3f}); {flops / 1e9:.4f} GFLOP, "
          f"{n_bytes / 1e6:.4f} MB; bound {ms:.5f} ms ({by})")
    return flops, n_bytes, ms, by


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
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        pinhole_rays,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        device_validate as dv,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        probe_features as pf,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        roofline_mount as rm,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import checkpoint
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.timing import (
        cuda_ms,
        frame_ms,
        mpaths_per_s,
        mrays_per_s,
        pt_frame_ms,
        queued_ms,
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
    names = ("whitted_megakernel", "pt_megakernel", "bvh_walk",
             "brute_intersect", "probes")

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
    probe_kernels = (kernels.op_rate, kernels.fma_peak, kernels.stack_walk)
    for k in (kernels.whitted_megakernel,) + probe_kernels:
        k.launches = 0
    img = render_image(scene, cfg_mk)
    torch.cuda.synchronize()
    launches = kernels.whitted_megakernel.launches
    probe_launches = [k.launches for k in probe_kernels]
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

    # 9. BVH walk: kernels against plain on the same rays
    t_bvh = time.perf_counter()
    bvh_err = {"closest": 0.0, "any": 0.0, "multi": 0.0}
    for label, tables, query, args in bvh_cases(dev):
        got = bvh_run(query, tables, args)
        want = bvh_run(query, tables, args, kernel=False)
        torch.cuda.synchronize()
        reading = hit_agreement(query, got, want)
        print(f"compare {label} ({query}): " + ", ".join(
            f"{k} {v:.3g}" for k, v in reading.items()))
        if rejects(reading, BVH_LIMITS):
            raise AssertionError(f"{label}: the BVH kernel and its plain "
                                 f"version disagree beyond {BVH_LIMITS}")
        if query == "multi":
            o_s, dirs, max_t, dead = args
            singles = torch.stack([
                kernels.bvh_any(tables, o_s, dirs[i], max_t, dead[i])
                for i in range(dirs.shape[0])])
            if not torch.equal(got, singles):
                raise AssertionError(f"{label}: the fused launch differs "
                                     "from one launch per light")
        bvh_err[query] = max(bvh_err[query], reading["err"])

    # 10. BVH main path through the entry points a user calls
    field = build_scene(scenes.sphere_field_scene(n_side=FIELD_SIDE,
                                                  res=RES), device=dev)
    cfg_bvh = RenderConfig()
    walk_kernels = (kernels.bvh_closest, kernels.bvh_any,
                    kernels.bvh_any_multi)
    for k in walk_kernels:
        k.launches = 0
    img = render_image(field, cfg_bvh)
    torch.cuda.synchronize()
    bvh_launches = [k.launches for k in walk_kernels]
    print(f"main path: render_image field{FIELD_SIDE} ({field.n_objects} "
          f"objects, {field.packets.nodes.shape[0]} nodes, depth "
          f"{field.packets.depth}) {RES}x{RES} depth {cfg_bvh.max_depth} "
          f"accel bvh, launches closest/any/multi {bvh_launches}")
    if bvh_launches[0] < 1 or bvh_launches[1] < 1:
        raise AssertionError("the BVH main path did not launch the walk")
    if img.shape != (RES, RES, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad BVH image: {tuple(img.shape)}")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("BVH image outside [0, 1]")
    print(f"BVH image mean {float(img.mean()):.5f}")
    save_png(str(ROOT / "build" / "field_smoke.png"), img)
    for k in walk_kernels:
        k.launches = 0
    img_multi = render_image(field, RenderConfig(accel_impl="multi"))
    torch.cuda.synchronize()
    multi_launches = kernels.bvh_any_multi.launches
    print(f"main path, accel_impl='multi': launches closest/any/multi "
          f"{[k.launches for k in walk_kernels]}")
    if multi_launches < 1:
        raise AssertionError("accel_impl='multi' did not launch the fused "
                             "walk")
    if not torch.equal(img_multi, img):
        raise AssertionError("accel_impl='multi' changed the image")
    small = build_scene(scenes.sphere_field_scene(n_side=FIELD_SIDE,
                                                  res=128), device=dev)
    bad, err = bad_fraction(render_image(small, cfg_bvh), render_image(
        small, RenderConfig(accel_impl="brute")))
    print(f"field{FIELD_SIDE} 128x128, BVH against brute force: "
          f"{bad * 100:.3f}% pixels beyond {ATOL}, max abs err {err:.3g}")
    if bad > MAX_BAD:
        raise AssertionError("the BVH image disagrees with brute force")
    del small
    for extra in (["--builtin", "spheres", "--res", str(RES)],
                  ["--builtin", "random"]):
        out = subprocess.run(
            [sys.executable, "-m",
             "u_4a_2s_p3d_raytracer_template2_tpu_torch.cli", "render",
             *extra, "--accel", "2", "-o", f"build/{extra[1]}.png"],
            cwd=ROOT, check=True, capture_output=True, text=True).stdout
        print("  cli: " + out.strip().replace("\n", "\n  cli: "))

    # 11. BVH timing: the walk alone on the main path's queries of drifting
    # frames, its bound from the kernel's own work counters; whole frames
    bvh_inputs = []
    for i in range(7):
        o, d = camera_rays(field, 0.37 * i)
        R = o.shape[0]
        q0, (r1, a1, ior1) = main_path_queries(
            field, Rays.make(o, d), torch.ones(R, dtype=torch.bool,
                                               device=dev),
            torch.ones(R, device=dev), cfg_bvh)
        q1, _ = main_path_queries(field, r1, a1, ior1, cfg_bvh)
        bvh_inputs.append(((o, d), (r1.origin, r1.direction), q0, q1))
    pk = field.packets
    bvh_times = {}
    for label, query, pick in (
            ("closest, primary", "closest", lambda x: x[0]),
            ("closest, level 1", "closest", lambda x: x[1]),
            ("any, primary hits, light 0", "any", lambda x: x[2][0]),
            ("any, level-1 hits, light 0", "any", lambda x: x[3][0]),
            ("multi, primary hits, both lights", "multi",
             lambda x: (x[2][0][0], torch.stack([q[1] for q in x[2]]),
                        x[2][0][2], torch.stack([q[3] for q in x[2]])))):
        args = [(pk, *pick(x)) for x in bvh_inputs]
        k_ms = queued_ms(lambda *a: bvh_run(query, a[0], a[1:]), args)
        call_ms = cuda_ms(lambda *a: bvh_run(query, a[0], a[1:]), args)
        p_ms = cuda_ms(lambda *a: bvh_run(query, a[0], a[1:], kernel=False),
                       args[:3], warmup=1)
        print(f"bvh {label}: kernel {k_ms:.4f} ms on the device ({call_ms:.4f} "
              f"ms a call from an idle device, host included), plain "
              f"{p_ms:.4f} ms ({args[0][1].shape[0]} rays, field{FIELD_SIDE} "
              f"{RES}x{RES}, {card})")
        bvh_times[label] = (k_ms, p_ms, bvh_work(query, pk, args[0][1:]))
    del bvh_inputs
    bvh_ms = frame_ms(field, cfg_bvh)
    print(f"frame BVH sweep: {bvh_ms:.4f} ms, {mrays_per_s(field, bvh_ms):.2f} "
          f"Mrays/s (primary+shadow), field{FIELD_SIDE} {RES}x{RES} depth "
          f"{cfg_bvh.max_depth}, {card}")
    profile_frames(f"BVH frame, sweep engine, field{FIELD_SIDE} {RES}x{RES}",
                   render_tile, lambda i: (field, px + 0.37 * i, py, cfg_bvh),
                   card, frames=5, share_of=("closest_kernel", "any_kernel"))
    print(f"BVH phases {time.perf_counter() - t_bvh:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    # 12. brute force: the kernels against their plain version on the same
    # rays
    t_brute = time.perf_counter()
    brute_err = {"closest": 0.0, "any": 0.0}
    for label, prims, tables, query, args in brute_cases(dev):
        got = brute_run(query, tables, args)
        want = brute_plain(query, prims, args)
        torch.cuda.synchronize()
        reading = hit_agreement(query, got, want)
        print(f"compare {label} ({query}, {args[0].shape[0]} rays): "
              + ", ".join(f"{k} {v:.3g}" for k, v in reading.items()))
        if rejects(reading, BRUTE_LIMITS):
            raise AssertionError(f"{label}: the brute-force kernel and its "
                                 f"plain version disagree beyond "
                                 f"{BRUTE_LIMITS}")
        brute_err[query] = max(brute_err[query], reading["err"])

    # 13. brute-force main path through the entry points a user calls
    field_nb = build_scene(scenes.sphere_field_scene(
        n_side=FIELD_SIDE, res=RES, accel=C.ACCEL_NONE), device=dev)
    brute_kernels = (kernels.brute_closest, kernels.brute_any)

    def brute_frame(scene, label):
        for k in brute_kernels + walk_kernels:
            k.launches = 0
        image = render_image(scene, cfg_bvh)
        torch.cuda.synchronize()
        counts = ([k.launches for k in brute_kernels],
                  [k.launches for k in walk_kernels])
        print(f"main path: render_image {label} ({scene.n_objects} objects) "
              f"{RES}x{RES} depth {cfg_bvh.max_depth} accel none, launches "
              f"brute closest/any {counts[0]}, walk closest/any/multi "
              f"{counts[1]}")
        if counts != ([4, 8], [0, 0, 0]):
            raise AssertionError(f"{label}: want 4 closest and 8 any-hit "
                                 "brute-force launches and no walk")
        if image.shape != (RES, RES, 3) or not bool(
                torch.isfinite(image).all()):
            raise AssertionError(f"bad brute-force image: "
                                 f"{tuple(image.shape)}")
        if float(image.min()) < 0.0 or float(image.max()) > 1.0:
            raise AssertionError("brute-force image outside [0, 1]")
        return image, counts[0]

    def against_walk(label, image, walk_image):
        bad, err = bad_fraction(image, walk_image)
        same = int((image == walk_image).all(dim=-1).sum())
        print(f"{label} brute force against the BVH walk: {bad * 100:.3f}% "
              f"pixels beyond {ATOL}, max abs err {err:.3g}, "
              f"{same} of {RES * RES} pixels bit-identical")
        if bad > MAX_BAD:
            raise AssertionError(f"{label}: the brute-force image disagrees "
                                 "with the BVH walk's")

    brute_img, brute_launches = brute_frame(field_nb, f"field{FIELD_SIDE}")
    against_walk(f"field{FIELD_SIDE} {RES}x{RES}", brute_img, img)  # phase 10
    save_png(str(ROOT / "build" / "field_brute_smoke.png"), brute_img)
    soup_sd = soup_scene(res=RES)
    soup_img, _ = brute_frame(build_scene(soup_sd, device=dev,
                                          accel=C.ACCEL_NONE), "soup")
    against_walk(f"soup {RES}x{RES}", soup_img,
                 render_image(build_scene(soup_sd, device=dev), cfg_bvh))
    save_png(str(ROOT / "build" / "soup_brute_smoke.png"), soup_img)
    del soup_img
    out = subprocess.run(
        [sys.executable, "-m", "u_4a_2s_p3d_raytracer_template2_tpu_torch.cli",
         "render", "--builtin", "spheres", "--accel", "0", "--res", str(RES),
         "-o", "build/spheres_brute.png"],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout
    print("  cli: " + out.strip().replace("\n", "\n  cli: "))

    # 14. brute-force timing: each kernel alone on the main path's queries
    # of drifting frames and on the soup's, per table mix; its plain version
    # on one batch; its bound from its own work counters; whole frames
    main_tb = intersect.brute_tables(field_nb.prims)
    sph_tb = intersect.brute_tables(subset(field_nb.prims, tri=False))
    soup_nb = build_scene(soup_scene(res=RES), device=dev,
                          accel=C.ACCEL_NONE)
    tri_prims = subset(soup_nb.prims, sph=False)
    tri_tb = intersect.brute_tables(tri_prims)

    def queries_of(scene, drift):
        o, d = camera_rays(scene, drift)
        R = o.shape[0]
        q0, (r1, a1, ior1) = main_path_queries(
            scene, Rays.make(o, d), torch.ones(R, dtype=torch.bool,
                                               device=dev),
            torch.ones(R, device=dev), cfg_bvh)
        q1, _ = main_path_queries(scene, r1, a1, ior1, cfg_bvh)
        return (o, d), (r1.origin, r1.direction), q0, q1

    field_q = [queries_of(field_nb, 0.37 * i) for i in range(7)]
    soup_q = [queries_of(soup_nb, 0.37 * i)[::2] for i in range(7)]
    brute_times = {}
    for label, query, prims, tb, inputs, pick in (
            ("closest, primary, main table (K4b)", "closest",
             field_nb.prims, main_tb, field_q, lambda x: x[0]),
            ("closest, level 1, main table", "closest", field_nb.prims,
             main_tb, field_q, lambda x: x[1]),
            ("any, primary hits, light 0, main table", "any",
             field_nb.prims, main_tb, field_q, lambda x: x[2][0]),
            ("any, level-1 hits, light 0, main table", "any",
             field_nb.prims, main_tb, field_q, lambda x: x[3][0]),
            ("closest, primary, field spheres (K4a)", "closest",
             subset(field_nb.prims, tri=False), sph_tb, field_q,
             lambda x: x[0]),
            ("any, primary hits, light 0, field spheres (K4c)", "any",
             subset(field_nb.prims, tri=False), sph_tb, field_q,
             lambda x: x[2][0]),
            ("closest, primary, soup triangles (K4e)", "closest", tri_prims,
             tri_tb, soup_q, lambda x: x[0]),
            ("any, primary hits, light 0, soup triangles (K4d)", "any",
             tri_prims, tri_tb, soup_q, lambda x: x[1][0])):
        args = [(tb, *pick(x)) for x in inputs]
        k_ms = queued_ms(lambda *a: brute_run(query, a[0], a[1:]), args)
        batch = [(query, prims, tuple(a[:PLAIN_BATCH]
                                      if torch.is_tensor(a) else a
                                      for a in x[1:])) for x in args[:3]]
        p_ms = cuda_ms(brute_plain, batch, warmup=1)
        print(f"brute {label}: kernel {k_ms:.4f} ms on the device "
              f"({args[0][1].shape[0]} rays, {tb.n_tri} triangles, "
              f"{tb.n_sph} spheres), plain {p_ms:.4f} ms on "
              f"{batch[0][2][0].shape[0]} of them ({card})")
        brute_times[label] = (k_ms, p_ms, args[0][1].shape[0],
                              batch[0][2][0].shape[0],
                              brute_work(query, tb, args[0][1:]))
    del field_q, soup_q
    brute_ms = frame_ms(field_nb, cfg_bvh)
    print(f"frame brute sweep: {brute_ms:.4f} ms, "
          f"{mrays_per_s(field_nb, brute_ms):.2f} Mrays/s (primary+shadow), "
          f"field{FIELD_SIDE} {RES}x{RES} depth {cfg_bvh.max_depth}, {card}")
    soup_ms = frame_ms(soup_nb, cfg_bvh)
    print(f"frame brute sweep: {soup_ms:.4f} ms, soup {RES}x{RES} depth "
          f"{cfg_bvh.max_depth}, {card}")
    profile_frames(f"brute frame, sweep engine, field{FIELD_SIDE} "
                   f"{RES}x{RES}", render_tile,
                   lambda i: (field_nb, px + 0.37 * i, py, cfg_bvh), card,
                   frames=5, share_of=("closest_kernel", "any_kernel"))
    print(f"brute-force phases {time.perf_counter() - t_brute:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    # 15. device probes: T2's FMA stream, T1's class rates, mount_low's op
    # mix and floor beside K1, T3's walk in both stack placements
    t_probe = time.perf_counter()
    peak = dv.vpu_peak(dev)
    rates = rm.part_rates(dev)
    mix = rm.part_mix(dev, RES)
    floor_ms = rm.mix_floor(mix, {op: r["rate"] for op, r in rates.items()},
                            RES * RES) * 1e3
    print(f"mount_low {RES}x{RES} depth 4: mix-weighted floor {floor_ms:.4f} "
          f"ms/frame (every sweep slot's tests in full) beside K1's kernel "
          f"{kernel_ms:.4f} ms and its bound {w_bound_ms:.5f} ms "
          f"({w_bound_by}); {card}")
    pf.check_walks(dev, field.packets.depth)
    walk = pf.time_walks(dev, field.packets.depth)
    walk_bound_ms, walk_bound_by = bound(0, walk["bytes"])
    print(f"T3 walk, {walk['nodes']} nodes, {pf.TIMED_ROWS} rays: stack in "
          f"shared memory {walk['shared']:.4f} ms, in a per-thread array "
          f"{walk['local']:.4f} ms, plain {walk['plain_ms']:.4f} ms, bound "
          f"{walk_bound_ms:.5f} ms (bytes); {card}")
    print(f"probe phase {time.perf_counter() - t_probe:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    # 16. the Whitted kernel against its plain version, case by case, on
    # the same rays and stream rows
    t_dist = time.perf_counter()
    for label, limits, wscene, wcfg, wdraws in whitted_cases(dev):
        got = whitted_run(wscene, wcfg, wdraws)
        want = whitted_run(wscene, wcfg, wdraws, kernel=False)
        torch.cuda.synchronize()
        check_pt(f"whitted {label}", got, want, limits)
    print(f"whitted cases {time.perf_counter() - t_dist:.1f} s")

    # 17. distribution main path: mount_low 512x512, spp 4 (AA + DoF, 16
    # samples a pixel), depth 4, jittered soft shadows, fuzzy reflection and
    # a 6x2048x2048x3 u8 skybox loaded from PNG faces, through render_image
    # and the CLI
    import tempfile

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import samples
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        subpixel_rays,
    )

    env = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    dscene, dcfg = dv.distribution_scene(dev, env_dir=env.name, res=RES,
                                         sky_side=DIST_SKY)
    t_load = time.perf_counter() - t0
    if not dscene.has_skybox or dscene.skybox.dtype != torch.uint8 or tuple(
            dscene.skybox.shape) != (6, DIST_SKY, DIST_SKY, 3):
        raise AssertionError("the distribution scene's skybox did not load "
                             "as [6, 2048, 2048, 3] u8")
    dlayout = samples.scene_layout(dscene, dcfg)
    n_sub = len(samples.subpixels(dcfg))
    print(f"distribution scene: skybox faces written as PNGs and the scene "
          f"built with them in {t_load:.1f} s; aperture "
          f"{float(dscene.camera.aperture):.5g} "
          f"({scenes.DISTRIBUTION_APERTURE_RATIO} pixels), "
          f"{n_sub} samples a pixel, {dlayout.n_rows} stream rows a ray "
          f"({sum(k[0] == 'shadow' for k in dlayout.rowmap) * 2} shadow, "
          f"{sum(k[0] == 'fuzzy' for k in dlayout.rowmap) * 3} fuzzy)")
    kernels.whitted_megakernel.launches = 0
    dimg = render_image(dscene, dcfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    dist_launches = kernels.whitted_megakernel.launches
    print(f"main path: render_image mount_low {RES}x{RES} spp {dcfg.spp} "
          f"depth {dcfg.max_depth} AA+DoF, soft shadows, fuzzy reflection, "
          f"skybox, engine=megakernel, kernel launches {dist_launches}")
    if dist_launches != n_sub:
        raise AssertionError(f"the distribution frame launched the kernel "
                             f"{dist_launches} times, not {n_sub}")
    if dimg.shape != (RES, RES, 3) or not bool(torch.isfinite(dimg).all()):
        raise AssertionError(f"bad distribution image: {tuple(dimg.shape)}")
    if float(dimg.min()) < 0.0 or float(dimg.max()) > 1.0:
        raise AssertionError("distribution image outside [0, 1]")
    dmean, dstd = float(dimg.mean()), float(dimg.std())
    print(f"distribution image mean {dmean:.5f}, std {dstd:.5f}")
    if not (0.05 < dmean < 0.95 and dstd > 0.01):
        raise AssertionError("the distribution image is flat or empty")
    save_png(str(ROOT / "build" / "mount_dist_smoke.png"), dimg)
    # the kernel against its plain version on the same draws
    px, py = pixel_grid(RES, RES, dev)
    plan = samples.draw_plan(torch.Generator(device=dev).manual_seed(1),
                             dlayout, dcfg, RES * RES)
    got = whitted_run(dscene, dcfg, plan)
    want = whitted_run(dscene, dcfg, plan, kernel=False)
    torch.cuda.synchronize()
    dist_bad, dist_mean, dist_err = check_pt(
        f"distribution frame {RES}x{RES} (main path shapes)", got, want,
        WHITTED_LIMITS["frame"])
    out = subprocess.run(
        [sys.executable, "-m", "u_4a_2s_p3d_raytracer_template2_tpu_torch.cli",
         "render", "--builtin", "mount_dist", "--res", str(RES),
         "--soft-shadow", "--fuzzy-reflection", "--skybox", "--env", env.name,
         "--engine", "megakernel",
         "-o", "build/mount_dist.png"], cwd=ROOT, check=True,
        capture_output=True, text=True).stdout
    print("  cli: " + out.strip().replace("\n", "\n  cli: "))

    # 18. timing: the kernel a subpixel launch and a frame's 16 launches on
    # this plan's rays and rows, its plain version, the draws alone, whole
    # frames, a frame's breakdown, and the bound from this plan's work
    sky = mk.sky_of(dscene, dcfg)
    dshape = mk.shape_of(dscene)
    dtbl, dlt, dbg = mk.scene_tables(dscene)
    launch_args = []
    for sdraw in plan:
        r = subpixel_rays(dscene, px, py, dcfg, sdraw)
        launch_args.append((dtbl, dlt, dbg, r.origin.contiguous(),
                            r.direction.contiguous(), dshape, dcfg,
                            sdraw.rows, sky, sdraw.ij))
    dist_ms = queued_ms(kernels.whitted_megakernel, launch_args)

    def frame_launches(args_list):
        for a in args_list:
            kernels.whitted_megakernel(*a)

    dist_frame_kernel_ms = cuda_ms(frame_launches, [(launch_args,)] * 5)
    dist_plain_ms = cuda_ms(mk.trace_rays_plain,
                            [(dshape, dtbl, dlt, dbg, *a[3:5], dcfg, a[7],
                              sky, a[9]) for a in launch_args[:3]], warmup=1)
    gens = [(torch.Generator(device=dev).manual_seed(50 + i),)
            for i in range(21)]
    draws_ms = cuda_ms(lambda g: samples.draw_plan(g, dlayout, dcfg,
                                                   RES * RES), gens)
    draws_bytes = n_sub * samples.draw_bytes(dlayout, dcfg, RES * RES)
    # the JAX tool's distribution section: the frame time (median of 21
    # frames, draws included), Mrays/s, the image's mean and std, and the
    # engine against the sweep at 64x64
    dv_dist = dv.distribution(dev, env_dir=env.name)
    dist_frame_ms = dv_dist["frame_ms"]
    print(f"distribution frame ({card}): kernel {dist_ms:.4f} ms a subpixel "
          f"launch (queued), {dist_frame_kernel_ms:.4f} ms for the frame's "
          f"{n_sub} launches (CUDA events); plain version "
          f"{dist_plain_ms:.2f} ms a subpixel; draws {draws_ms:.4f} ms and "
          f"{draws_bytes / 1e6:.1f} MB a frame; frame {dist_frame_ms:.4f} ms "
          f"(median of 21), "
          f"{mrays_per_s(dscene, dist_frame_ms, dcfg):.2f} Mrays/s "
          f"(primary+shadow, res^2 spp^2 (1+L))")
    profile_frames(f"whitted distribution frame, megakernel engine, mount_low "
                   f"{RES}x{RES} spp 4", render_tile,
                   lambda i: (dscene, px + 0.37 * i, py, dcfg,
                              torch.Generator(device=dev).manual_seed(70 + i)),
                   card)
    dw = {}
    for a in launch_args:
        dw = add_work(dw, whitted_work(dscene, a[3], a[4], dcfg, a[7], a[9]))
    R = RES * RES
    d_flops = work_flops(dw, dscene.prims.n_sph, dscene.prims.n_tri)
    # each value the kernel reads once: 2 rows a jittered (hit, light) pair,
    # 3 a fuzzy child
    row_bytes = 4 * (2 * dw["jitters"] + 3 * dw["fuzzy"])
    all_row_bytes = 4 * R * dlayout.n_rows * n_sub
    d_bytes = (n_sub * R * 36 + row_bytes + 3 * dw["sky"]
               + 4 * n_sub * (dtbl.numel() + dlt.numel() + dbg.numel()))
    dist_bound_ms, dist_bound_by = bound(d_flops, d_bytes)
    print(f"distribution work ({n_sub} subpixels): {dw['tests']} nodes "
          f"({dw['tests'] / (n_sub * R):.3f} per ray), {dw['hits']} hits, "
          f"{dw['feelers']} of {dw['pairs']} jittered shadow rays facing "
          f"their light, testing {dw['tri_tests']} triangles and "
          f"{dw['sph_tests']} spheres, {dw['fuzzy']} fuzzy children, "
          f"{dw['sky']} sky texels; {d_flops / 1e9:.4f} GFLOP, "
          f"{d_bytes / 1e6:.4f} MB (rows read {row_bytes / 1e6:.2f} MB of "
          f"{all_row_bytes / 1e6:.1f} MB drawn); bound {dist_bound_ms:.5f} "
          f"ms ({dist_bound_by}; operations {d_flops / PEAK_F32_FLOPS * 1e3:.5f}"
          f" ms, bytes {d_bytes / PEAK_BYTES * 1e3:.5f} ms), "
          f"{dist_bound_ms / n_sub:.5f} ms a launch")
    env.cleanup()
    print(f"distribution phases {time.perf_counter() - t_dist:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    def bvh_entry(name, query, label, replaces, launches, **extra):
        k_ms, p_ms, (_, _, b_ms, b_by) = bvh_times[label]
        return {"name": name, "route": "cuda", "source": src + "bvh_walk.cu",
                "replaces": pk_src + replaces, **extra,
                "launches": launches, "max_abs_err": bvh_err[query],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}

    def brute_entry(name, query, label, replaces):
        k_ms, p_ms, rays, plain_rays, (_, _, b_ms, b_by) = brute_times[label]
        return {"name": name, "route": "cuda",
                "source": src + "brute_intersect.cu",
                "replaces": pi_src + replaces,
                "entry": f"brute_{query}_launch", "timed_on": label,
                "launches": brute_launches[query == "any"],
                "max_abs_err": brute_err[query], "ms": k_ms,
                "rays": rays, "plain_ms": p_ms, "plain_rays": plain_rays,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    src = "u_4a_2s_p3d_raytracer_template2_tpu_torch/csrc/"
    pk_src = "u_4a_2s_p3d_raytracer_template2_tpu/accel/packets.py"
    pi_src = "u_4a_2s_p3d_raytracer_template2_tpu/ops/pallas_intersect.py"
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
        "distribution_frame": {
            "scene": f"mount_low {RES}x{RES}, spp {dcfg.spp}, depth "
                     f"{dcfg.max_depth}, soft shadows, fuzzy reflection, "
                     f"u8 skybox {DIST_SKY}^2 x 6",
            "launches": dist_launches, "max_abs_err": dist_err,
            "mean_abs_err": dist_mean, "share_beyond_atol": dist_bad,
            "ms": dist_ms, "frame_kernel_ms": dist_frame_kernel_ms,
            "plain_ms": dist_plain_ms, "frame_ms": dist_frame_ms,
            "draws_ms": draws_ms, "draws_bytes": draws_bytes,
            "bound_ms": dist_bound_ms / n_sub, "bound_by": dist_bound_by,
            "frame_bound_ms": dist_bound_ms, "library_ms": None},
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
    },
        bvh_entry("bvh_walk closest", "closest", "closest, primary", ":770",
                  bvh_launches[0], also_replaces=pk_src + ":843"),
        bvh_entry("bvh_walk any", "any", "any, primary hits, light 0",
                  ":813", bvh_launches[1]),
        bvh_entry("bvh_walk any multi", "multi",
                  "multi, primary hits, both lights", ":729", multi_launches),
        brute_entry("brute_intersect closest, spheres (K4a)", "closest",
                    "closest, primary, field spheres (K4a)", ":186"),
        brute_entry("brute_intersect closest, triangles and spheres (K4b)",
                    "closest", "closest, primary, main table (K4b)", ":377"),
        brute_entry("brute_intersect any, spheres (K4c)", "any",
                    "any, primary hits, light 0, field spheres (K4c)",
                    ":525"),
        brute_entry("brute_intersect any, triangles (K4d)", "any",
                    "any, primary hits, light 0, soup triangles (K4d)",
                    ":553"),
        brute_entry("brute_intersect closest, triangles (K4e)", "closest",
                    "closest, primary, soup triangles (K4e)", ":590"),
    {
        "name": "probes op_rate (T1)", "route": "cuda",
        "source": src + "probes.cu",
        "replaces": "tools/roofline_mount.py:165",
        "launches": probe_launches[0],
        "max_abs_err": rates["fma"]["abs_err"], "timed_on": "fma",
        "ms": rates["fma"]["ms"], "plain_ms": rates["fma"]["plain_ms"],
        "bound_ms": rates["fma"]["bound_ms"], "bound_by": "operations",
        "library_ms": None,
        "by_class": {op: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "rate", "err", "abs_err")}
                     for op, r in rates.items()},
    }, {
        "name": "probes fma_peak (T2)", "route": "cuda",
        "source": src + "probes.cu",
        "replaces": "tools/device_validate.py:143",
        "launches": probe_launches[1], "max_abs_err": peak["abs_err"],
        "max_rel_err": peak["err"], "tflops": peak["tflops"],
        "ms": peak["ms"], "plain_ms": peak["plain_ms"],
        "bound_ms": peak["flop"] / PEAK_F32_FLOPS * 1e3,
        "bound_by": "operations", "library_ms": None,
    }, {
        "name": "probes stack_walk (T3)", "route": "cuda",
        "source": src + "probes.cu",
        "replaces": "tools/probe_pallas_features.py:87",
        "launches": probe_launches[2], "max_abs_err": walk["abs_err"],
        "ms": walk["shared"], "local_stack_ms": walk["local"],
        "plain_ms": walk["plain_ms"], "bound_ms": walk_bound_ms,
        "bound_by": walk_bound_by, "library_ms": None,
    },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
