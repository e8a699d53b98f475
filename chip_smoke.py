"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each raising on failure:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile csrc/whitted_megakernel.cu, csrc/pt_megakernel.cu,
     csrc/bvh_walk.cu, csrc/brute_intersect.cu, csrc/probes.cu and
     csrc/perray_traverse.cu with nvcc, one process each, started together;
     print the build times and ptxas's register and spill report.
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
     plain version on the same rays under BVH_LIMITS (bvh_cases,
     live_agreement: readings over the live slots, and every dead slot
     exactly (BIG, -1) or occluded, the kernel writing into poisoned
     outputs): the main path's primary rays, level-1 rays (with the
     sweep's dead mask, and with EDGE_LIVE of their hitting slots live)
     and shadow segments with their dead masks, the 18,496-sphere field's
     primary rays, and a soup of all four primitive types with incoherent
     and axis-parallel rays; the fused launch against one launch per
     light, exactly;
  10. main path: render_image of the field with the walk's launch counters
     reset just before and read just after; accel_impl="multi" gives the
     same image through the fused walk; at 128x128 the BVH image against
     brute force; the PNG; the CLI render command on the built-in sphere
     field and random scene with --accel 2;
  11. timing: each of the frame's 12 walk launches (a closest hit a
     level, a shadow query a level and light) alone on the sweep's own
     queries and dead masks (frame_queries) of seven drifting frames, and
     the fused multi-light query on level 0's, as device time with the
     launches queued (utils/timing.queued_ms) and as CUDA-event time per
     call, its plain version, its bound (bvh_work: the kernel's own work
     counters, the live rays' inputs, every slot's answer), the frame's
     sums, a whole frame and its breakdown under torch.profiler with its
     device ops and the walk's share of device time.
  Brute-force path (the same field under ACCEL_NONE, 512x512, depth 4,
  sweep):
  12. the kernels (closest, any) against their plain version on the same
     rays under BRUTE_LIMITS (brute_cases, live_agreement: readings over
     the live slots, and every dead slot exactly (BIG, -1) or occluded, the
     kernel writing into poisoned outputs), the plain version PLAIN_BATCH
     slots a call: the main path's primary rays, level-1 rays and shadow
     segments with their dead masks at max_t 1 and unbounded; the frame's
     own queries of levels 1-3 with the masks the sweep hands them
     (frame_queries); the level-1 query with 0, 1, 31, 33 and 4,097 live
     slots; the soup's triangles alone, spheres alone and both tables with
     incoherent rays, segments and axis-parallel rays; twinned primitives
     in table order and in shuffled rows, with many rays and with few (the
     table then split into slices), where only the tie rule decides;
  13. main path: render_image of the field with the launch counters reset
     just before and read just after (4 closest, 8 any-hit, no walk); the
     image against the BVH walk's of phase 10; the soup at 512x512 the same
     way; the PNGs; the CLI render command with --accel 0;
  14. timing: the live slots of each level; each kernel alone on the
     frame's 12 queries with their masks (4 closest, 8 any hit), per table
     mix (the field's spheres alone, the soup's triangles alone), as device
     time with the launches queued, its plain version on one batch, the
     bound from the plain version's count of its work (each test charged
     BRUTE_STAGE_OPS by where it ended, intersect.brute_stages), the
     frame's 4 and 8 launches summed; whole frames and a frame's breakdown
     under torch.profiler with the compaction's, the closest hit's and the
     any hit's device time. Each K4 entry of the kernels line gives the
     slots and live rays its "ms" was timed on and its "plain_ms"'s.
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
  Wavefront path (the compacted queue, models/whitted_wavefront.py; the
  field 512x512, depth 4):
  19. W1: render_image of the field on engine="wavefront" with every
     launch counter reset just before and read just after (the walk, no
     Whitted or brute-force kernel), the queue's live entries a round read
     after an eager frame (render_tile: a capture records none), the image
     against the sweep's of phase 10 (max abs
     err WAVE_ATOL), frames beside the sweep's, and a profile (device ops,
     busy time and idle share, the walk's share);
  20. W2: the same under ACCEL_NONE through the brute-force kernels,
     against phase 13's image;
  21. W3: the field on engine="megakernel" (over the kernel's 256
     primitives) runs the wavefront: no Whitted launch, W1's launches and
     W1's image bit for bit; mount_low on the wavefront against the Whitted
     kernel's image under WHITTED_LIMITS;
  22. W4: phase 17's distribution plan, drawn once, through the sweep and
     the wavefront (WAVE_ATOL): the queue reads the same draws;
  23. W5: the BVH frame at wavefront_capacity 0.05: finite, a mean abs
     difference under 0.1 against W1, primaries-only pixels unchanged.
  Per-ray path (accel/traverse.py: csrc/perray_traverse.cu on the card):
  24. the four per-ray kernels (the median BVH's closest and any hit, the
     grid DDA's closest and shadow hit) against their plain version on the
     same rays under PERRAY_LIMITS (perray_cases, perray_agreement: ids
     equal but at equal t, every live slot's occlusion equal, every dead
     slot exactly (BIG, -1) or occluded, the kernel writing into poisoned
     outputs): the field's own frame queries as a BVH and as a grid scene
     (primaries, level-1 rays and shadow segments with the sweep's dead
     masks, unbounded, under init_fail_occludes), segments most of which
     miss the grid, the field's grid cut to its fullest cell (a
     max_per_cell that is no multiple of 4), twinned primitives, the
     four-type soup, the corner grid whose exit-axis ties decide the
     answer, and a 26-level chain whose rays push an entry at every level
     and hit the 21st pushed (deep_tree_scene); then P1: render_image of
     the field under accel_impl="perray" (the median BVH's walk) as a
     compiled frame, its launches counted on the card (4 closest, 8 any
     hit), against the walk's image under WHITTED_LIMITS; level-0 hit ids
     against the walk kernel's (only ties may differ);
  25. P2: the field under ACCEL_GRID with accel_impl="perray" (the DDA),
     and P2q with reference_grid_shadow_initfail, compiled, their launches
     counted on the card, P2 against the walk's image, P2q bit-equal to an
     eager frame that counts the shadow rays whose grid entry failed; each
     kernel on the frames' own queries of seven drifting frames, queued
     (utils/timing.queued_ms, the primitive table packed once a scene, as
     a frame's 12 queries share one pack), beside its plain version and its bound (perray_work:
     the kernel's own counts of node box tests or cell steps and primitive
     tests, and each launch's live rays with their mean and largest node
     visits or cell steps); the compiled frames' times; the grid section of
     tools/device_validate. A first compiled frame over PERRAY_CUT_S
     seconds moves both phases to PERRAY_CUT_RES, with the reason
     printed.
  Gradients (models/whitted_megakernel.WhittedTrace, parallel/dist.py):
  26. the Whitted kernel's autograd.Function against autograd straight
     through its plain version on the same CUDA tensors (function_cases:
     mount_low, the four-type scene with two lights and the distribution
     plan at 64x64): the gradients of tbl, lt, bg, o and d under GRAD_LIMIT,
     the forward bit for bit the kernel's output, one launch in the forward
     and none in the backward (chip_faults.py plants a backward that drops
     o's and d's gradient);
  27. the main path: train_step_full on mount_low 512x512, depth 4, on the
     megakernel engine, three steps of cli fit's light recovery (the loss
     and light 0's offset fall), then three steps of fit --fit all on the
     wavefront; the launch counters around each step (one Whitted launch a
     step on the megakernel engine: the forward's); a step timed as
     bench.py's gradient line times it (targets drifting 1e-7 a step,
     median of TIMED_STEPS, CUDA events) beside a forward frame, its
     peak memory and its breakdown under torch.profiler;
  28. one backward of the camera, light and geometry groups on the field at
     512x512, depth 4, on the wavefront, through the walk and under
     ACCEL_NONE through brute force: finite, the traversals' kernels
     launched; at 64x64 the two gradients agree (GRAD_LIMIT where the two
     images are bit-equal, JAX's 5e-3 otherwise);
  29. cli fit as a subprocess on the card: --fit lights at 512x512 (lr
     LIGHT_LR) and --fit geometry at 128x128 (lr GEOMETRY_LR), on the
     megakernel engine, each printing falling offsets.
  Sharding (parallel/dist.py, ranks started by parallel/launch.py) and the
  front end:
  30. two gloo ranks on cuda:0 (NCCL refuses two ranks on one device),
     each path driven eagerly (render_image_sharded_eager, the eager
     step) with its launch counters set to 0 just before and read just
     after, and compiled (a CUDA graph a rank: the render or the step's
     loss and gradients, gloo's collective eager after the replay):
     render_image_sharded of mount_low 512x512, depth 4, on the megakernel
     engine (one K1 launch a rank, the gathered image bit-equal to phase
     4's) and of the BVH field (4 closest and 8 any-hit walk launches a
     rank, bit-equal to phase 10's); one train_step_full of the light
     recovery at LIGHT_LR (one K1 launch a rank, the loss and light
     positions within SHARD_RTOL of the single process's step, the
     replicas equal); the compiled frames bit-equal to the eager ones, two
     chained compiled steps within GRAD_LIMIT of the eager ones
     (step_agreement) and within SHARD_RTOL of the single process; each
     replay's launches counted on the card (replay_launch_reads: K1 1, the
     walk 4 + 8), the host's launch calls, graph launches and collective
     events a call (host_calls), the slices all-gathered again on the CPU
     (the NCCL form) equal to the frame; the frames and steps timed on
     each rank, compiled and eager (CUDA events and host wall, medians),
     beside the single process's (sharded_rejects holds the checks;
     chip_faults.py plants SHARD_FAULTS);
  31. in the same ranks, glsl_world's path-traced frame at 512x512, 10
     bounces (one K3 launch a rank), each rank's slice against the plain
     version on that rank's rays and uniforms, the whole frame of slices
     under PT_LIMITS["glsl"] (pt_frame_agreement: the limit is a 512x512
     frame's), the frame's mean beside a single-process frame's; two
     compiled frames of
     one generator bit-equal to two eager ones (the second drawn anew, the
     generator left where eager leaves it), K3 1 a replay;
  32. one NCCL rank in a child process: every path of 30-31 with its
     collective captured inside the graph, the same checks, one graph
     launch and no collective from the host a compiled call, the eager
     render and step against the single process's bit for bit (the step
     so where the single-process step repeats bit for bit, else within
     SHARD_RTOL), and NCCL's version;
  33. cli orbit, view and live (keys "aw  a q", an 80-column preview) as
     subprocesses at 512x512 on the megakernel engine: exit 0, their PNGs,
     their FPS lines, live's accumulation counts and the captures each
     prints (orbit 1, view and live 2: the moving camera replays one
     graph); preview_u8 on the card against the CPU within 1 u8 level.
  Compiled programs (utils/graphs.py: render_image, the megakernel's
  tile, make_render_frame and make_train_step on the card are CUDA graphs,
  captured at a first call and replayed; every main-path phase above
  makes that first call, then sets the wrappers' counts to 0 and drives
  the path as a replay under torch.profiler: its launches are the
  kernel nodes of the graphs it replayed (utils/profiling.graph_kernels),
  each seen running on the card among the profiler's device kernel
  events (utils/profiling.device_launches; the profiler drops records),
  and the wrappers' counts must stay 0, since a replay launches from no
  wrapper, replay_launches):
  34. for mount_low 512x512 on the megakernel engine, the distribution
     frame of phase 17, the BVH field on the sweep and on the wavefront,
     the brute field on the sweep and on the wavefront, P1, P2 and P2q
     (the per-ray kernels' frames), glsl_world's path-traced frame on the
     megakernel and on the plain engine, and train_step_full on mount_low
     512x512, depth 4,
     on the megakernel engine (the light recovery) and on the wavefront
     (fit --fit all), each from an empty graph cache (graph_path): the
     first call's host ms, the capture's own ms, the graph pool's MiB and
     max_memory_allocated before and after; the replays against the eager
     function (the frames bit for bit on two fresh seeds and a generator
     advanced by one frame, the second seed on a moved and relit scene,
     each generator left where eager leaves it, replay_agreement; two
     chained steps within GRAD_LIMIT on the loss, every parameter and
     every update, step_agreement); the kernels' launches a compiled call
     counted on the device;
     for the compiled and the eager function the host's kernel launch
     calls and graph launches, device ops and idle share under the
     profiler, CUDA-event and host-wall ms (medians) and utils/timing
     .loop_ms, each beside the card's name and power limit; one capture
     over every call (20 or more); then a 16-frame orbit of mount_low with
     the camera moving (one capture, every frame bit-equal to eager) and
     16 progressive path-tracer frames bit-equal to 16 eager ones.
     chip_faults.py plants GRAPH_FAULTS under graph_checks, the same
     checks at 128x128.
  35. on a box with two or more cards, one NCCL rank a card over every
     card up to 4 (rank r on cuda:r): phase 30's paths and checks against
     the single process, each rank's compiled and eager times and NCCL's
     version; on a box with one card one line says it did not run.
On a card, brute-force queries of more than 48 primitives go through the
brute-force kernels, so the plain sweep that phase 3 holds the Whitted
kernel against runs them on its 66-primitive field, and phase 10's 128x128
brute force is them too; both comparisons stay sound, since phase 12 holds
the brute-force kernels against their own plain version.
The line before the last is a JSON object of the kernels (the walk's and
brute force's entries each with the wavefront frame and the gradient frame
they served, the Whitted kernel's with the Function's readings and the
train steps; K1's, K3's and the walk's with their launches on each rank of
phases 30-31); the last line is the JSON device record.
"""
import concurrent.futures
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.megakernels import (
    frame_queries,
    warp_max_sum,
)

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
    operations per frame, the host's kernel launch calls and graph launches
    per frame (its CPU-side events named *LaunchKernel* and *GraphLaunch*)
    and the busiest kernels; with ``share_of``, the device time of the
    kernels whose names hold one of those strings, and its share of the
    busy time. Returns them as a dict (wall_ms, busy_ms, idle, device_ops,
    launch_calls, graph_launches, kernels_ms)."""
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
    # the host's launch calls: kernels (runtime and driver API) and graphs
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    calls = {"launch_calls": sum("LaunchKernel" in n for n in names) / frames,
             "graph_launches": sum("GraphLaunch" in n for n in names)
             / frames}
    if not device:
        print(f"profile {label}: host wall {wall_ms:.4f} ms/frame; device "
              "time not measured (the profiler saw no device events); "
              f"launch calls a frame {calls}")
        return {"wall_ms": wall_ms, **calls}
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
          f"{len(device) / frames:.1f} device ops/frame, "
          f"{calls['launch_calls']:.1f} kernel launch calls and "
          f"{calls['graph_launches']:.1f} graph launches/frame; busiest: "
          + "; ".join(f"{name[:90]} {us / 1e3 / frames:.4f} ms/frame"
                      for name, us in top))
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle": 1 - busy_ms / wall_ms, "device_ops": len(device) / frames,
           **calls}
    if share_of:
        parts = {s: sum(us for name, us in by_name.items() if s in name)
                 / 1e3 / frames for s in share_of}
        ms = sum(parts.values())
        print(f"profile {label}: kernels named {'/'.join(share_of)} "
              f"{ms:.4f} ms/frame, {100 * ms / busy_ms:.1f}% of device busy ("
              + ", ".join(f"{s} {v:.4f}" for s, v in parts.items()) + ")")
        out["kernels_ms"] = ms
    return out


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
    texel; ``warp_nodes``, the sum over warps of 32 consecutive rays of the
    nodes their deepest ray walks (``tests / (32 warp_nodes)`` is the share
    of a warp's lanes the walk keeps busy)."""
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
    nodes = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    for lvl in range(layout.shape.n_levels):
        # slot = ray * W + path at every level
        nodes += active.view(o.shape[0], -1).sum(dim=1)
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
        _, (children, _) = whitted._level_step(
            scene, rays, active, ior, cfg, True,
            samples.NodeDraws(layout, lvl, vals))
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
    w["warp_nodes"] = warp_max_sum(nodes)
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
    the kernel does; ``warp_bounces``, the sum over warps of 32 consecutive
    paths of the live bounces of their longest path."""
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
    bounces = torch.zeros(R, dtype=torch.int64, device=rays.origin.device)
    for i in range(uni.shape[0]):
        r, active = state[0], state[3]
        n_alive = int(active.sum())
        if n_alive == 0:
            break
        w["alive"].append(n_alive)
        bounces += active
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
    w["warp_bounces"] = warp_max_sum(bounces)
    return w


# ---------------------------------------------------------------------------
# the BVH walk (csrc/bvh_walk.cu)

# The walk's kernels against their plain version on the same rays, per case,
# over the live slots: the share of rays whose closest-hit ids differ, the
# largest t difference relative to max(t, 1) where they agree, and the share
# of occlusion results that differ; and "dead", the share of dead slots
# whose answer is not exactly (BIG, -1), or occluded, read with the kernel
# writing into poisoned outputs (live_agreement). The kernel is built
# without multiply-add contraction (kernels/build.py), so its f32
# operations are the plain version's one for one and the sound kernel reads
# 0 on all four.
BVH_LIMITS = {"ids": 1e-4, "t_rel": 1e-5, "occ": 1e-4, "dead": 0.0}
# Operations per test in the walk's bound: a child's slab test about 20; a
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
            scene, rays, active, ior, cfg, True,
            samples.NodeDraws(samples.scene_layout(scene, cfg), 0, None))
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
    args); query "closest" takes (o, d) or (o, d, dead), "any" (o, d,
    max_t, dead) and "multi" (o, dirs [L, R, 3], max_t, dead [L, R]). The
    main scene at 512x512: its primary rays, its level-1 reflection and
    refraction rays with the sweep's dead mask, and with EDGE_LIVE of their
    hitting slots live, and its shadow segments at the primary hits with
    their dead masks, per light and fused over both, at max_t 1 (the main
    path's) and unbounded; the 18,496-sphere field's primary rays; a soup
    of 2,000 triangles, 2,000 spheres, a plane and a box with incoherent
    rays and segments, and axis-parallel rays started on the box's face."""
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
    queries, (kids, active, _) = main_path_queries(
        field, Rays.make(o, d), torch.ones(R, dtype=torch.bool, device=dev),
        torch.ones(R, device=dev), RenderConfig())
    level1 = (kids.origin, kids.direction, ~active)
    yield (f"{tag} level-1 reflection and refraction rays, "
           f"{live_of(level1[2], 0)} of {2 * R} slots live", field.packets,
           "closest", level1)
    _, hit_id = bvh_run("closest", field.packets, level1, kernel=False)
    hits = torch.nonzero(hit_id >= 0)[:, 0]
    g = torch.Generator(device="cpu").manual_seed(5)
    for k in EDGE_LIVE:
        dead = torch.ones_like(active)
        dead[hits[torch.randperm(hits.numel(), generator=g)[:k].to(dev)]] = (
            False)
        yield (f"{tag} level-1 rays, {k} live", field.packets, "closest",
               (*level1[:2], dead))
    for max_t in (1.0, C.BIG):
        for li, (so, sd, _, dead) in enumerate(queries):
            yield (f"{tag} shadow segments, light {li}, max_t {max_t:g}",
                   field.packets, "any", (so, sd, max_t, dead))
        yield (f"{tag} shadow segments of both lights fused, max_t "
               f"{max_t:g}", field.packets, "multi",
               (queries[0][0], torch.stack([q[1] for q in queries]), max_t,
                torch.stack([q[3] for q in queries])))
    del field, queries, kids, level1

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


def bvh_run(query, tables, args, kernel=True, poison=False):
    """One case's answer from the kernel or from its plain version.
    ``poison``: the kernel writes into outputs filled with values no slot
    should keep (poisoned_outputs)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets

    out = {"out": poisoned_outputs(query, args)} if poison else {}
    if query == "closest":
        fn = kernels.bvh_closest if kernel else packets.closest_hit_plain
        return fn(tables, *args, **out)
    if query == "any":
        fn = kernels.bvh_any if kernel else packets.any_hit_plain
        return fn(tables, *args, **out)
    if kernel:
        return kernels.bvh_any_multi(tables, *args, **out)
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
    """(GFLOP, MB, bound ms, bound by, live) of one launch on ``args``, by
    brute force's convention (brute_work): the work the kernel's own walk
    counts (its per-ray counters: child box tests; triangle and sphere
    tests by where each ended, each charged BRUTE_STAGE_OPS; plane and box
    tests), against the live rays' inputs (a closest hit's origin and
    direction; an any hit's direction for each live (set, ray) pair and the
    origin of each ray with one), every slot's answer and dead byte, and the
    tables once. ``live``: the live slots, or (set, ray) pairs."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels

    o, dead = args[0], dead_of(query, args)
    R = o.shape[0]
    counts = torch.zeros((R, kernels.WORK_COUNTS), dtype=torch.int32,
                         device=o.device)
    fn = {"closest": kernels.bvh_closest, "any": kernels.bvh_any,
          "multi": kernels.bvh_any_multi}[query]
    fn(tables, *args, counts=counts)
    c = counts.sum(dim=0, dtype=torch.int64).tolist()
    nodes, stages, planes, boxes = c[0], c[1:7], c[7], c[8]
    tris, sphs = sum(stages[:4]), sum(stages[4:])
    flops = (nodes * NODE_TEST + planes * PLANE_TEST + boxes * BOX_TEST
             + sum(n * ops for n, ops in zip(stages, BRUTE_STAGE_OPS)))
    n_bytes = 4 * sum(t.numel() for t in (tables.nodes, tables.rows,
                                          tables.planes))
    slots = R if query == "closest" else args[1].numel() // 3
    live = live_of(dead, slots)
    if query == "closest":
        n_bytes += 24 * live + 8 * R      # o, d in; t, id out
    else:
        rays = (R if dead is None
                else int((~dead.view(-1, R)).any(dim=0).sum()))
        n_bytes += 12 * rays + 12 * live + slots  # o; d in; occ out
    if dead is not None:
        n_bytes += slots
    ms, by = bound(flops, n_bytes)
    per = max(live, 1)
    print(f"  work: {live} live of {slots} slots; {nodes / per:.3f} child "
          f"box tests, {tris / per:.3f} triangle (ended at det "
          f"{stages[0] / per:.3f}, u {stages[1] / per:.3f}, v "
          f"{stages[2] / per:.3f}, with t {stages[3] / per:.3f}), "
          f"{sphs / per:.3f} sphere (at the discriminant "
          f"{stages[4] / per:.3f}, with roots {stages[5] / per:.3f}), "
          f"{planes / per:.3f} plane and {boxes / per:.3f} box tests a live "
          f"slot; {flops / 1e9:.4f} GFLOP, {n_bytes / 1e6:.4f} MB; bound "
          f"{ms:.5f} ms ({by})")
    return flops, n_bytes, ms, by, live


# ---------------------------------------------------------------------------
# the brute-force kernels (csrc/brute_intersect.cu)

# The brute-force kernels against their plain version on the same rays,
# per case: the readings of hit_agreement over the live slots, with
# BVH_LIMITS' values, and "dead", the share of dead slots whose answer is
# not exactly (BIG, -1), or occluded, which must be 0 (live_agreement).
# The kernels are built without multiply-add contraction, so the sound
# kernels read 0 on all four (chip_faults.py plants faults that they
# reject).
BRUTE_LIMITS = {"ids": 1e-4, "t_rel": 1e-5, "occ": 1e-4, "dead": 0.0}
# Rays per call of the plain version on the card: its [R, 2048]
# temporaries take 268 MB each at this size; a whole 512x512 level at once
# would need tens of GB.
PLAIN_BATCH = 32768
# Operations of one brute-force test by where it ended, in
# ops/intersect.BRUTE_STAGES' order: a triangle test at the det gate, the u
# gate, the v gate, with its t; a sphere test at the discriminant, with its
# roots. Counted from csrc/prim_tests.cuh's formulas, each add, subtract,
# multiply, divide, square root, min, max and compare one operation
# (negation, abs and selects none): 15, 27, 45 and 52 for a triangle, 20
# and 30 for a sphere, plus the one compare that folds the test's t into
# the ray's answer (t < kBig in a closest hit, t < max_t in an any hit).
BRUTE_STAGE_OPS = (16, 28, 46, 53, 21, 31)
# The field's primaries' closest-hit bound at 512x512 (operations), as the
# brute-force kernel's own per-stage counters counted it on the card before
# the count moved to the plain version: brute_work must give it again.
PRIMARY_BOUND_MS = 0.6080
BRUTE_KERNEL_NAMES = ("brute_compact", "brute_closest", "brute_any")

WAVE_ATOL = 5e-4       # wavefront against sweep, tests/test_wavefront.py:39
PERRAY_CUT_S = 30.0    # a per-ray frame slower than this runs at
PERRAY_CUT_RES = 256   # this resolution instead
# Live slots of the masked cases at the compaction's and the ray groups'
# edges: none, one, a warp less one and more one, a group of 4,096 and one
EDGE_LIVE = (0, 1, 31, 33, 4097)


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


def live_of(dead, n):
    """Live slots of a query's dead mask (all ``n`` without one)."""
    return n if dead is None else int((~dead).sum())


def brute_cases(dev):
    """The brute-force kernels' kernel-against-plain cases as (label,
    prims, tables, query, args): the plain version reads ``prims``, the
    kernel ``tables``; query "closest" takes (o, d) or (o, d, dead), "any"
    (o, d, max_t, dead). The main scene under ACCEL_NONE at 512x512: its
    primary rays, its level-1 reflection and refraction rays, and its
    shadow segments at the primary hits with their dead masks, at max_t 1
    (the main path's) and unbounded; the frame's own closest-hit queries of
    levels 1-3 and shadow queries of levels 1-3 with the masks the sweep
    hands them (frame_queries); the level-1 query with EDGE_LIVE of its
    hitting slots live. The soup of 2,000 triangles and 2,000 spheres with
    incoherent rays and segments (30% dead) through its triangles alone
    (K4e, K4d), its spheres alone (K4a, K4c) and both (K4b), and
    axis-parallel rays; tie_scene's rays aimed at twinned primitives and
    down the z axis, with the kernel's rows in a random order (8,256 rays,
    and 256, which split the table into many slices, so that twins and the
    tied triangle and sphere fall in different slices) and in table order
    (twins in one slice)."""
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
    del queries, kids
    closest, shadows = frame_queries(field, o, d, RenderConfig())
    n_lights = len(shadows) // len(closest)
    for lvl in range(1, len(closest)):
        q = closest[lvl]
        yield (f"{tag} the frame's level-{lvl} rays, {live_of(q[2], 0)} of "
               f"{q[0].shape[0]} slots live", field.prims, tables, "closest",
               q)
        for li in range(n_lights):
            q = shadows[lvl * n_lights + li]
            yield (f"{tag} the frame's level-{lvl} shadow segments, light "
                   f"{li}, {live_of(q[3], 0)} live", field.prims, tables,
                   "any", q)
    ro, rd, rdead = closest[1]
    _, hit_id = brute_plain("closest", field.prims, closest[1])
    hits = torch.nonzero(hit_id >= 0)[:, 0]
    g = torch.Generator(device="cpu").manual_seed(5)
    for k in EDGE_LIVE:
        dead = torch.ones_like(rdead)
        dead[hits[torch.randperm(hits.numel(), generator=g)[:k].to(dev)]] = (
            False)
        yield (f"{tag} the frame's level-1 rays, {k} live", field.prims,
               tables, "closest", (ro, rd, dead))
    del field, closest, shadows

    soup = build_scene(soup_scene(), device=dev, accel=C.ACCEL_NONE).prims
    rng = np.random.default_rng(2)
    n = 65536

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    o, d = rng.uniform(-8, 8, (n, 3)), rng.normal(size=(n, 3))
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
    yield ("twinned primitives in table order, aimed rays", ties, tb,
           "closest", (o, d))
    few = torch.cat([k[:96], 4096 + k[:96], 8192 + k[:64]])  # 256 rays
    yield ("twinned primitives, rows shuffled, 256 aimed rays", ties,
           shuffled, "closest", (o[few].contiguous(), d[few].contiguous()))


def poisoned_outputs(query, args):
    """A kernel's outputs for a case, filled with values no slot should
    keep (NaN and 0x5a5a5a5a; not occluded), so that a slot the kernel
    leaves unwritten shows."""
    R, dev = args[0].shape[0], args[0].device
    if query == "closest":
        return (torch.full((R,), float("nan"), device=dev),
                torch.full((R,), 0x5A5A5A5A, dtype=torch.int32, device=dev))
    return torch.zeros(args[1].shape[:-1], dtype=torch.bool, device=dev)


def brute_run(query, tables, args, poison=False):
    """One case's answer from the kernel. ``poison``: write into
    poisoned_outputs."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels

    fn = kernels.brute_closest if query == "closest" else kernels.brute_any
    if not poison:
        return fn(tables, *args)
    return fn(tables, *args, out=poisoned_outputs(query, args))


def dead_of(query, args):
    """A case's dead mask, or None."""
    if query == "closest":
        return args[2] if len(args) > 2 else None
    return args[3]


def brute_plain(query, prims, args, batch=PLAIN_BATCH):
    """One case's answer from the plain version, ``batch`` slots a call."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    o, d, dead = args[0], args[1], dead_of(query, args)
    parts = []
    for s in range(0, o.shape[0], batch):
        rays = Rays.make(o[s:s + batch], d[s:s + batch])
        dd = None if dead is None else dead[s:s + batch]
        if query == "closest":
            parts.append(intersect.closest_hit_plain(prims, rays, dd))
        else:
            parts.append(intersect.any_hit_plain(prims, rays, args[2], dd))
    if query == "closest":
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    return torch.cat(parts)


def live_agreement(query, got, want, dead=None):
    """Readings of a kernel's answer ``got`` against the plain version's
    ``want`` (BVH_LIMITS, BRUTE_LIMITS): hit_agreement's over the live
    slots, and "dead", the share of dead slots whose answer is not exactly
    (BIG, -1), or occluded."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C

    if dead is None:
        return {**hit_agreement(query, got, want), "dead": 0.0}
    live = ~dead
    if query == "closest":
        reading = (hit_agreement(query, tuple(x[live] for x in got),
                                 tuple(x[live] for x in want))
                   if bool(live.any()) else {"ids": 0.0, "t_rel": 0.0,
                                             "err": 0.0})
        bad = (got[0][dead] != C.BIG) | (got[1][dead] != -1)
    else:
        reading = (hit_agreement(query, got[live], want[live])
                   if bool(live.any()) else {"occ": 0.0, "err": 0.0})
        bad = ~got[dead]
    reading["dead"] = float(bad.double().mean()) if bad.numel() else 0.0
    return reading


def brute_work(query, prims, tables, args, batch=PLAIN_BATCH):
    """(GFLOP, MB, bound ms, bound by, live rays) of one launch on
    ``args``: the tests the plain version counts by where each ended
    (ops/intersect.brute_stages, ``batch`` slots a call: every live ray
    tests every row in a closest hit; an any hit tests them in table order
    up to and including its first occluder; dead slots test nothing), each
    charged BRUTE_STAGE_OPS, against the live rays in, every slot's answer
    out, the dead mask and the tables once."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    o, d, dead = args[0], args[1], dead_of(query, args)
    max_t = args[2] if query == "any" else None
    R = o.shape[0]
    stages = sum(intersect.brute_stages(
        prims, Rays.make(o[s:s + batch], d[s:s + batch]), max_t,
        None if dead is None else dead[s:s + batch])
        for s in range(0, R, batch)).tolist()
    flops = sum(n * ops for n, ops in zip(stages, BRUTE_STAGE_OPS))
    tris, sphs = sum(stages[:4]), sum(stages[4:])
    live = live_of(dead, R)
    n_bytes = (20 * tables.n_sph + 48 * tables.n_tri + 24 * live
               + R * (8 if query == "closest" else 1)
               + (R if dead is not None else 0))
    ms, by = bound(flops, n_bytes)
    per = max(live, 1)
    print(f"  work: {live} live rays of {R} slots; {tris / per:.3f} triangle "
          f"tests a live ray (ended at det {stages[0] / per:.3f}, u "
          f"{stages[1] / per:.3f}, v {stages[2] / per:.3f}, with t "
          f"{stages[3] / per:.3f}), {sphs / per:.3f} sphere tests (at the "
          f"discriminant {stages[4] / per:.3f}, with roots "
          f"{stages[5] / per:.3f}); {flops / 1e9:.4f} GFLOP, "
          f"{n_bytes / 1e6:.4f} MB; bound {ms:.5f} ms ({by})")
    return flops, n_bytes, ms, by, live


# ---------------------------------------------------------------------------
# the per-ray traversals (csrc/perray_traverse.cu)

# The per-ray kernels against their plain version (accel/traverse.py's
# *_plain) on the same rays, per case, over the live slots: hit_agreement's
# readings, "ids_other_t", the share of live slots whose ids differ at
# another t, and "dead" (live_agreement). The kernels run the plain
# version's f32 operations in its order and are built without
# multiply-add contraction (kernels/build.py), so the sound kernels read 0
# on all; ids may differ only at equal t, and no live slot's occlusion may
# differ (chip_faults.py plants PERRAY_FAULTS that these limits reject).
PERRAY_LIMITS = {"ids": 1e-4, "ids_other_t": 0.0, "t_rel": 1e-5,
                 "occ": 0.0, "dead": 0.0}
# Operations of a DDA cell step in the bound: the smallest of three next
# t, the step, the add to the next t, the stop test and the cell's index
PERRAY_DDA_STEP = 12
PERRAY_KINDS = ("bvh", "grid")
PERRAY_CORNER_RAYS = 4096
# deep_tree_scene: its spheres (a chain of DEEP_SPHERES - 2 inner levels)
# and the one its rays hit, whose stack entry a stack shorter than the
# chain would overwrite
DEEP_SPHERES, DEEP_HIT = 28, 8


def perray_kernels():
    """The per-ray kernels' wrappers: closest and any hit of the median BVH
    and of the grid DDA."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels

    return (kernels.perray_bvh_closest, kernels.perray_bvh_any,
            kernels.grid_closest, kernels.grid_any)


def perray_run(kind, query, scene, args, kernel=True, poison=False,
               counts=None):
    """One case's answer from a per-ray kernel (``kind`` "bvh" or "grid",
    ``query`` "closest" with args (o, d, dead) or "any" with (o, d, max_t,
    dead, init_fail_occludes)) or from its plain version. ``poison``: the
    kernel writes into poisoned_outputs; ``counts``: its work counters."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import traverse
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Rays

    accel = scene.bvh if kind == "bvh" else scene.grid
    o, d, rest = args[0], args[1], args[2:]
    if not kernel:
        fn = {("bvh", "closest"): traverse.bvh_closest_plain,
              ("bvh", "any"): traverse.bvh_any_plain,
              ("grid", "closest"): traverse.grid_closest_plain,
              ("grid", "any"): traverse.grid_any_plain}[kind, query]
        if kind == "bvh" and query == "any":
            rest = rest[:2]
        return fn(accel, scene.prims, Rays.make(o, d), *rest)
    out = {"out": poisoned_outputs(query, args)} if poison else {}
    if query == "closest":
        fn = (kernels.perray_bvh_closest if kind == "bvh"
              else kernels.grid_closest)
        return fn(accel, scene.prims, o, d, rest[0], counts=counts, **out)
    max_t, dead, init_fail = rest
    if kind == "bvh":
        return kernels.perray_bvh_any(accel, scene.prims, o, d, max_t, dead,
                                      counts=counts, **out)
    return kernels.grid_any(accel, scene.prims, o, d, max_t, dead,
                            init_fail, counts=counts, **out)


def perray_agreement(query, got, want, dead):
    """live_agreement's readings of a per-ray kernel against its plain
    version, and "ids_other_t": the share of live slots whose ids differ
    where t differs too."""
    reading = live_agreement(query, got, want, dead)
    if query == "closest":
        live = (torch.ones_like(got[1], dtype=torch.bool) if dead is None
                else ~dead)
        other = (got[1] != want[1]) & (got[0] != want[0]) & live
        reading["ids_other_t"] = float(other.double().sum()
                                       / max(int(live.sum()), 1))
    return reading


def corner_grid_scene(dev, n=PERRAY_CORNER_RAYS, seed=7):
    """(scene, o, d): a 2x1x2 grid over [0, 2] x [0, 1] x [0, 2] whose one
    object, a sphere of radius 0.2 at (0.5, 0.5, 0.5) in cell (0, 0, 0),
    is listed in cell (1, 0, 0) alone; and ``n`` rays from (-1, y, -1)
    along the diagonal (1, 0, 1) / sqrt(2), y in [0.25, 0.75], which pass
    through the cells' corners: at each step the next boundary t of x and
    of z are equal. The DDA takes the first axis of the smallest t, x, so
    it steps into cell (1, 0, 0) and finds the sphere there (its t lies
    before the cell's exit); a DDA that took z first would step into
    (0, 0, 1) and miss it. Only the tie rule decides."""
    import dataclasses

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        GridArrays,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef

    sd = SceneDef()
    sd.accel_type = C.ACCEL_GRID
    sd.set_camera(eye=[-1, 0.5, -1], at=[0, 0.5, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=16, res_y=16, aperture_ratio=0,
                  focal_ratio=1)
    m = sd.add_material([0.7, 0.7, 0.7], 1.0, [1, 1, 1], 0.1, 20, 0, 1)
    sd.add_sphere([0.5, 0.5, 0.5], 0.2, m)
    sd.add_light([10, 10, 10], [1, 1, 1])
    scene = build_scene(sd, device=dev)
    items = torch.full((4, 8), -1, dtype=torch.int32, device=dev)
    items[1, 0] = 0
    grid = GridArrays(
        bbox_min=torch.zeros(3, device=dev),
        bbox_max=torch.tensor([2.0, 1.0, 2.0], device=dev),
        cell_items=items, cell_count=(items >= 0).sum(dim=1).int(),
        unbounded_ids=scene.grid.unbounded_ids, nx=2, ny=1, nz=2,
        max_per_cell=8)
    rng = np.random.default_rng(seed)
    o = np.stack([np.full(n, -1.0), rng.uniform(0.25, 0.75, n),
                  np.full(n, -1.0)], 1).astype(np.float32)
    d = np.array([1.0, 0.0, 1.0], np.float32) / np.float32(np.sqrt(2.0))
    d = np.broadcast_to(d, (n, 3))
    return (dataclasses.replace(scene, grid=grid),
            torch.from_numpy(o).to(dev),
            torch.from_numpy(np.ascontiguousarray(d)).to(dev))


def deep_tree_scene(dev, n=PERRAY_CORNER_RAYS, seed=9):
    """(scene, o, d): a BVH scene of DEEP_SPHERES spheres k = 1, 2, ...
    at x = 2^k, radius 2^k / 4, whose spatial-median tree is a chain (each
    node's right child the sphere of largest x, a leaf), DEEP_SPHERES - 2
    inner levels; and ``n`` rays along +x from x = -10 within 0.01 of the
    x axis. Sphere DEEP_HIT lies on the axis; each other sphere's centre
    sits 0.8 r off it in y and in z, so the rays pass through its box and
    miss it. A ray descends the chain to its bottom leaf and pushes every
    level's sphere, nearest last: its hit is the pushed entry of sphere
    DEEP_HIT, the 21st pushed. A stack of 21 entries or fewer writes the
    pushes past its top into its top slot, loses that entry, and answers
    a miss; the walk's 64 entries hold them all."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef

    sd = SceneDef()
    sd.accel_type = C.ACCEL_BVH
    sd.set_camera(eye=[-10, 0, 0], at=[0, 0, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=16, res_y=16, aperture_ratio=0,
                  focal_ratio=1)
    m = sd.add_material([0.7, 0.7, 0.7], 1.0, [1, 1, 1], 0.1, 20, 0, 1)
    for k in range(1, DEEP_SPHERES + 1):
        r = 0.25 * 2.0 ** k
        off = 0.0 if k == DEEP_HIT else 0.8 * r
        sd.add_sphere([2.0 ** k, off, off], r, m)
    sd.add_light([0, 100, 0], [1, 1, 1])
    scene = build_scene(sd, device=dev)
    rng = np.random.default_rng(seed)
    o = np.stack([np.full(n, -10.0), rng.uniform(-0.01, 0.01, n),
                  rng.uniform(-0.01, 0.01, n)], 1).astype(np.float32)
    d = np.broadcast_to(np.array([1.0, 0.0, 0.0], np.float32), (n, 3))
    return (scene, torch.from_numpy(o).to(dev),
            torch.from_numpy(np.ascontiguousarray(d)).to(dev))


def cut_grid(scene):
    """``scene`` with its grid's item table cut to its fullest cell's
    count, so that max_per_cell is the largest count (no multiple of 8,
    as accel/grid.build_grid pads it)."""
    import dataclasses

    g = scene.grid
    m = max(1, int(g.cell_count.max()))
    return dataclasses.replace(scene, grid=dataclasses.replace(
        g, cell_items=g.cell_items[:, :m].contiguous(), max_per_cell=m))


def perray_cases(dev, res=RES, n_side=FIELD_SIDE, n_rays=65536):
    """The per-ray kernels' kernel-against-plain cases as (label, kind,
    scene, query, args) (perray_run's arguments): on the field of n_side^2
    spheres at res x res, as a BVH and as a grid scene, the frame's own
    queries under accel_impl="perray" (frame_queries: the primary rays,
    the level-1 rays with the sweep's dead mask, the shadow segments of
    levels 0 and 1 with theirs, and level 0's unbounded), the grid's
    shadow segments under init_fail_occludes, and segments from a box
    three times the grid's, most of which miss it, with and without the
    quirk; tie_scene (twinned primitives, where only the tie rule decides)
    and the four-type soup (a plane, a box, triangles and spheres) as both
    with ``n_rays`` incoherent rays, segments with a dead mask and
    axis-parallel rays in the box's face; corner_grid_scene's diagonal
    rays; the field's grid cut to its fullest cell (cut_grid) under the
    level-0 shadow segments and primaries; and deep_tree_scene's rays and
    segments."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes

    cfg = RenderConfig(accel_impl="perray")
    rng = np.random.default_rng(4)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    for kind, accel in zip(PERRAY_KINDS, (C.ACCEL_BVH, C.ACCEL_GRID)):
        scene = build_scene(scenes.sphere_field_scene(
            n_side=n_side, res=res, accel=accel), device=dev)
        tag = f"{kind} field{n_side} {res}x{res}"
        closest, shadows = frame_queries(scene, *camera_rays(scene), cfg)
        n_lights = len(shadows) // len(closest)
        yield f"{tag} primary rays", kind, scene, "closest", closest[0]
        yield (f"{tag} level-1 rays, {live_of(closest[1][2], 0)} of "
               f"{closest[1][0].shape[0]} slots live", kind, scene,
               "closest", closest[1])
        for k, (so, sd, max_t, dead) in enumerate(shadows[:2 * n_lights]):
            yield (f"{tag} shadow segments, level {k // n_lights}, light "
                   f"{k % n_lights}, max_t {max_t:g}", kind, scene, "any",
                   (so, sd, max_t, dead, False))
        so, sd, _, dead = shadows[0]
        yield (f"{tag} shadow segments, level 0, light 0, max_t 1e+30",
               kind, scene, "any", (so, sd, C.BIG, dead, False))
        if kind == "grid":
            yield (f"{tag} shadow segments, level 0, light 0, max_t 1, "
                   "init_fail_occludes", kind, scene, "any",
                   (so, sd, 1.0, dead, True))
            cut = cut_grid(scene)
            m = cut.grid.max_per_cell
            yield (f"{tag} primary rays, the grid cut to max_per_cell {m}",
                   kind, cut, "closest", closest[0])
            yield (f"{tag} shadow segments, level 0, light 0, max_t 1, the "
                   f"grid cut to max_per_cell {m}", kind, cut, "any",
                   (so, sd, 1.0, dead, False))
            del cut
            lo, hi = scene.grid.bbox_min.cpu().numpy(), \
                scene.grid.bbox_max.cpu().numpy()
            n = n_rays
            o = lo + (hi - lo) * rng.uniform(-1, 2, (n, 3))
            seg = lo + (hi - lo) * rng.uniform(-1, 2, (n, 3)) - o
            dead = rng.uniform(size=n) < 0.2
            for quirk in (False, True):
                yield (f"{tag} segments from a box 3x the grid's, max_t 1"
                       + (", init_fail_occludes" if quirk else ""), kind,
                       scene, "any",
                       (t(o), t(seg), 1.0, t(dead, torch.bool), quirk))
        del scene, closest, shadows, so, sd, dead

    n = n_rays
    o = t(rng.uniform(-8, 8, (n, 3)))
    d = rng.normal(size=(n, 3))
    d = t(d / np.linalg.norm(d, axis=1, keepdims=True))
    segs = t(rng.uniform(-8, 8, (n, 3))) - o
    dead = t(rng.uniform(size=n) < 0.3, torch.bool)
    m = min(n_rays, 4096)
    ao = t(np.stack([np.full(m, -6.0), rng.uniform(-7, -4, m),
                     rng.uniform(-6.5, -4.7, m)], 1))
    ad = np.zeros((m, 3))
    ad[np.arange(m), rng.integers(1, 3, m)] = rng.choice([-1.0, 1.0], m)
    ad = t(ad)
    for kind, accel in zip(PERRAY_KINDS, (C.ACCEL_BVH, C.ACCEL_GRID)):
        ties = build_scene(tie_scene(), device=dev, accel=accel)
        yield (f"{kind} tie scene incoherent rays", kind, ties, "closest",
               (o, d, None))
        yield (f"{kind} tie scene segments, max_t 1", kind, ties, "any",
               (o, segs, 1.0, dead, kind == "grid"))
        soup = build_scene(soup_scene(), device=dev, accel=accel)
        yield (f"{kind} soup incoherent rays, dead slots", kind, soup,
               "closest", (o, d, dead))
        yield (f"{kind} soup segments, max_t 1", kind, soup, "any",
               (o, segs, 1.0, dead, False))
        yield (f"{kind} soup axis-parallel rays in a box face", kind, soup,
               "closest", (ao, ad, None))
        yield (f"{kind} soup axis-parallel segments in a box face, max_t "
               "1e+30", kind, soup, "any", (ao, ad * 3.0, C.BIG, None,
                                            False))
        del ties, soup
    corner, co, cd = corner_grid_scene(dev)
    yield ("grid corner diagonal rays (exit-axis ties)", "grid", corner,
           "closest", (co, cd, None))
    yield ("grid corner diagonal segments, max_t 1e+30", "grid", corner,
           "any", (co, cd, C.BIG, None, False))
    deep, do, dd = deep_tree_scene(dev)
    yield (f"bvh deep tree ({DEEP_SPHERES} spheres in a chain) rays", "bvh",
           deep, "closest", (do, dd, None))
    yield (f"bvh deep tree ({DEEP_SPHERES} spheres in a chain) segments, "
           "max_t 1e+30", "bvh", deep, "any", (do, dd, C.BIG, None, False))


def perray_work(kind, query, scene, args):
    """(GFLOP, MB, bound ms, bound by, live) of one per-ray launch on
    ``args``, by the BVH walk's convention (bvh_work): the work the kernel
    counts itself (its counted instantiation: node box tests, each
    NODE_TEST, or DDA cell steps, each PERRAY_DDA_STEP; primitive tests by
    where each ended, BRUTE_STAGE_OPS; plane and box tests), the live
    rays' inputs, every slot's answer and dead byte, and the tables (the
    tree's or grid's arrays, the primitive rows and the plane ids) once.
    Prints the launch's live rays and their mean and largest inner-node
    visits (a visit reads one record and tests two boxes) or cell steps,
    which pace a launch of few live rays."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels

    o, dead = args[0], dead_of(query, args)
    R = o.shape[0]
    counts = torch.zeros((R, kernels.WORK_COUNTS), dtype=torch.int32,
                         device=o.device)
    perray_run(kind, query, scene, args, counts=counts)
    c = counts.sum(dim=0, dtype=torch.int64).tolist()
    steps, stages, planes, boxes = c[0], c[1:7], c[7], c[8]
    per_ray = counts[:, 0].long()
    if dead is not None:
        per_ray = per_ray[~dead]
    if kind == "bvh":  # the root's box test, then two a visited inner node
        per_ray = (per_ray - 1).clamp(min=0) // 2
    if per_ray.numel():
        print(f"  walk: {per_ray.numel()} live rays, "
              f"{float(per_ray.double().mean()):.3f} mean and "
              f"{int(per_ray.max())} most "
              + ("inner-node visits" if kind == "bvh" else "cell steps")
              + " a ray")
    flops = (steps * (NODE_TEST if kind == "bvh" else PERRAY_DDA_STEP)
             + planes * PLANE_TEST + boxes * BOX_TEST
             + sum(n * ops for n, ops in zip(stages, BRUTE_STAGE_OPS)))
    accel = scene.bvh if kind == "bvh" else scene.grid
    tables = [v for v in vars(accel).values() if isinstance(v, torch.Tensor)]
    n_bytes = (sum(x.numel() * x.element_size() for x in tables)
               + 64 * scene.prims.params.shape[0])
    live = live_of(dead, R)
    n_bytes += 24 * live + (8 if query == "closest" else 1) * R
    if dead is not None:
        n_bytes += R
    ms, by = bound(flops, n_bytes)
    per = max(live, 1)
    print(f"  work: {live} live of {R} slots; "
          f"{steps / per:.3f} {'node box tests' if kind == 'bvh' else 'cell steps'}, "
          f"{sum(stages[:4]) / per:.3f} triangle, {sum(stages[4:]) / per:.3f} "
          f"sphere, {planes / per:.3f} plane and {boxes / per:.3f} box tests "
          f"a live slot; {flops / 1e9:.4f} GFLOP, {n_bytes / 1e6:.4f} MB; "
          f"bound {ms:.5f} ms ({by})")
    return flops, n_bytes, ms, by, live


# ---------------------------------------------------------------------------
# Gradients (phases 26-29): models/whitted_megakernel.WhittedTrace, the
# Whitted kernel's autograd.Function, and parallel/dist.py's train steps

# WhittedTrace against autograd straight through trace_rays_plain on the
# same CUDA inputs, per input: max |a - b| <= GRAD_LIMIT[0] * max |b| +
# GRAD_LIMIT[1]. The Function's backward is that plain version's own
# autograd, so the two differ only where a CUDA backward adds in another
# order (atomic adds into the table's rows); chip_faults.py's planted
# backward, which drops o's and d's gradient, reads 1.0 on both.
GRAD_LIMIT = (1e-4, 1e-7)
GRAD_INPUTS = ("tbl", "lt", "bg", "o", "d")
GRAD_RES = 64
TRAIN_STEPS = 3
# mount_low's light sits 173 units away, so moving it by (1, -0.7, 0.5)
# changes the image little: at lr 1e4 the offset falls about 2% a step
LIGHT_LR = 1e4
# mount_low's largest glass sphere moved by 0.4 r: at 128x128 an lr of 0.3
# brings the printed centre offsets down (cli fit --fit geometry)
GEOMETRY_LR = 0.3
BENCH_LR = 0.01       # bench.py:233-286's gradient line
TIMED_STEPS = 11


def function_cases(dev):
    """Phase 26's cases at GRAD_RES, as (label, scene, cfg, one subpixel's
    draws): mount_low; the four-type scene (two lights, a plane and a box);
    the distribution plan (AA spp 2, DoF, motion blur, soft shadows, fuzzy
    reflection and the u8 sky: whitted_cases' all-flags case)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.samples import (
        Draws,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
        mount_scene,
    )

    cfg = RenderConfig(engine="megakernel")
    none = Draws(None, None, None, None, None)
    yield ("mount_low", build_scene(mount_scene(GRAD_RES), device=dev), cfg,
           none)
    yield ("four-type, 2 lights",
           build_scene(four_type_scene(GRAD_RES), device=dev), cfg, none)
    [(_, _, scene, dcfg, draws)] = whitted_cases(
        dev, only="four-type all flags, sky u8")
    yield "distribution plan, sky u8", scene, dcfg, draws[1]


def function_readings(apply, scene, cfg, s, seed=0):
    """The five inputs' gradients through ``apply`` (WhittedTrace.apply or
    a planted copy) and straight through trace_rays_plain, on the same
    CUDA leaves with a seeded cotangent: a dict of each input's relative
    error (max |a - b| over max |b|), whether the forward equals the
    kernel's own output bit for bit, and the Whitted kernel's launches in
    the forward and in the backward."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_megakernel as mk,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
        subpixel_rays,
    )

    cam = scene.camera
    px, py = pixel_grid(cam.res_x, cam.res_y, scene.device)
    rays = subpixel_rays(scene, px, py, cfg, s)
    shape, sky = mk.shape_of(scene), mk.sky_of(scene, cfg)
    leaves = [t.detach().clone().requires_grad_() for t in
              (*mk._pack_tables(scene), rays.origin, rays.direction)]
    gen = torch.Generator(device=scene.device).manual_seed(seed)
    ct = torch.rand(px.shape[0], 3, device=scene.device, generator=gen)
    k = kernels.whitted_megakernel
    n0 = k.launches
    out = apply(*leaves, shape, cfg, s.rows, sky, s.ij)
    n1 = k.launches
    got = torch.autograd.grad(out, leaves, ct, allow_unused=True)
    n2 = k.launches
    direct = k(*[t.detach() for t in leaves], shape, cfg, s.rows, sky, s.ij)
    plain = mk.trace_rays_plain(shape, *leaves, cfg, s.rows, sky, s.ij)
    want = torch.autograd.grad(plain, leaves, ct, allow_unused=True)
    err, scale = {}, {}
    for name, a, b, x in zip(GRAD_INPUTS, got, want, leaves):
        a = torch.zeros_like(x) if a is None else a
        b = torch.zeros_like(x) if b is None else b
        scale[name] = float(b.abs().max())
        err[name] = float((a - b).abs().max())
    bad, fwd_err = bad_fraction(out.detach(), plain.detach())
    return {"err": err, "scale": scale,
            "forward_equal": bool(torch.equal(out.detach(), direct)),
            "forward_vs_plain": (bad, fwd_err),
            "launches": (n1 - n0, n2 - n1)}


def function_rejects(r):
    """Why phase 26's limits reject readings ``r`` (empty: they pass)."""
    why = [f"{n} gradient off by {r['err'][n]:.3g} (scale {r['scale'][n]:.3g})"
           for n in GRAD_INPUTS
           if not r["err"][n] <= GRAD_LIMIT[0] * r["scale"][n] + GRAD_LIMIT[1]]
    if not r["forward_equal"]:
        why.append("forward differs from the kernel's output")
    if r["launches"] != (1, 0):
        why.append(f"launches (forward, backward) {r['launches']}, not (1, 0)")
    return why


def falling(values):
    """Whether a sequence falls from its first value to its last."""
    return len(values) > 1 and values[-1] < values[0]


def offsets_printed(stdout, what):
    """The offsets ``cli fit`` printed after ``what`` ("light offset" or
    "center offset"), one a step."""
    return [float(line.split(what)[1]) for line in stdout.splitlines()
            if what in line]


# Phases 30-32 and 35: the sharded paths (parallel/dist.py) on ranks started
# by parallel/launch.py, each path eager (the reference) and compiled (a CUDA
# graph a rank: on NCCL with the collective inside it, on gloo with the
# collective after the replay). Phases 30-31 run two gloo ranks on cuda:0
# (NCCL refuses two ranks on one device), phase 32 one NCCL rank, phase 35
# one NCCL rank a card on a box with two or more cards (up to 4).
SHARD_RANKS = 2
SHARD_MAX_CARDS = 4
SHARD_TIMEOUT_S = 300.0
SHARD_FRAMES = 21      # timed frames (medians), after 3 warm-up frames
SHARD_STEPS = 5        # timed train steps (medians), after 1 warm-up step
SHARD_RTOL = 1e-6      # the sharded train step against the single process's
SHARD_PARTS = ("mount", "field", "train", "pt")
SHARD_PT_SEED = 7      # the path tracer's compiled frames draw from it
# planted faults the phase-30 checks must reject (chip_faults.py), and the
# parts each is run on there
SHARD_FAULTS = ("rank 1 writes its slice one pixel early",
                "the gradient all-reduce skipped",
                "the rank generator seeded once at capture, so every replay "
                "draws the capture's values",
                "rank 1's slice placed one row early in the all-gather path",
                "the last rank traces its path-tracer slice one row early")
SHARD_FAULT_PARTS = (("mount",), ("train",), ("pt",), ("mount",), ("pt",))
# profiler reads of a replay before the last one stands (replay_launches),
# and the reads that saw fewer runs than the replayed graphs hold
LAUNCH_READS = 4
LOST_READS = []
# the host's profiler events of a collective issued eagerly
COLLECTIVE_EVENT = re.compile(r"^(nccl|gloo):|^c10d::")


def shard_setup():
    """The card for a rank: ``cuda:LOCAL_RANK`` on NCCL (one rank a card,
    dist.rank_device), cuda:0 on gloo (the ranks share it); f32
    throughout."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dist.backend_of() == "nccl":
        dev = dist.rank_device(None, "nccl")
    else:
        dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def counted(fn, kernels_):
    """fn()'s result and each kernel's launches in it, the counts set to 0
    just before and read just after (the device synchronised)."""
    for k in kernels_:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kernels_}


def replay_launches(fn, kernels_):
    """fn()'s result and each kernel's launches in it, for a compiled call
    whose graph is captured. The wrappers' counts, set to 0 just before
    and read just after, must stay 0 (a replay runs the kernels without
    their wrappers: a call that ran eagerly raises). The launches are the
    kernel nodes of the graphs the call replayed (CUDA's own node list of
    each graph, utils/profiling.graph_kernels, times its replays in the
    call), and the profiler's device kernel events
    (utils/profiling.device_launches) must show each such kernel running
    on the card, and none more often than the graphs hold it. The profiler
    drops device records (late in a long process it read 3 of the 4
    closest-hit nodes of a sweep frame's graph in every read), so a read
    that misses a kernel altogether is taken again, up to LAUNCH_READS
    reads, and every read short of the graphs' count is noted in
    LOST_READS. If no read shows every kernel, the profiler's last read is
    returned, for the caller's check to reject."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.profiling import (
        device_launches,
        graph_kernels,
        mangled,
    )

    for _ in range(LAUNCH_READS):
        before = {id(g): g.replays for g in graphs.CACHE.graphs.values()}
        for k in kernels_:
            k.launches = 0
        out, seen = device_launches(fn, kernels_)
        eager = {k.__name__: k.launches for k in kernels_ if k.launches}
        if eager:
            raise AssertionError(f"the wrappers launched {eager} in a call "
                                 "that should replay a CUDA graph")
        held = dict.fromkeys(seen, 0)
        for g in graphs.CACHE.graphs.values():
            times = g.replays - before.get(id(g), 0)
            if times:
                names = graph_kernels(g.graph)
                for k in kernels_:
                    held[k.__name__] += times * mangled(names,
                                                        k.device_kernel)
        if seen != held:
            LOST_READS.append({"seen": seen, "held": held})
        if all((seen[k] > 0) == (held[k] > 0) and seen[k] <= held[k]
               for k in held):
            return out, held
    return out, seen


def replay_launch_reads(fn, kernels_, calls=3):
    """replay_launches over ``calls`` calls of ``fn``, each counted in its
    own profiler session: (the last output, each kernel's largest count,
    every call's counts)."""
    reads = []
    for _ in range(calls):
        out, n = replay_launches(fn, kernels_)
        reads.append(n)
    return out, {k: max(r[k] for r in reads) for k in reads[0]}, reads


def host_calls(fn, calls=3):
    """What the host issues a call of ``fn`` (after one call outside the
    profiler), from torch.profiler's CPU-side events over ``calls`` calls:
    kernel launch calls (*LaunchKernel*), graph launches (*GraphLaunch*)
    and events of a collective issued eagerly (nccl:*, gloo:*, c10d::*)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    return {"launch_calls": sum("LaunchKernel" in n for n in names) / calls,
            "graph_launches": sum("GraphLaunch" in n for n in names) / calls,
            "collective_events": sum(bool(COLLECTIVE_EVENT.search(n))
                                     for n in names) / calls}


def frame_times(fn, frames=SHARD_FRAMES, warmup=3):
    """Medians of (CUDA-event ms, host wall ms) of ``fn()`` frames, each
    started on an idle device and ended by a synchronise."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for i in range(warmup + frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((start.elapsed_time(end),
                          (time.perf_counter() - t0) * 1e3))
    return tuple(float(np.median([t[j] for t in times])) for j in (0, 1))


def light_step(dev):
    """Phase 27's light recovery on mount_low 512x512, depth 4, on the
    megakernel engine: (the scene, its image, ``step()``: one eager
    train_step_full at LIGHT_LR from light 0 moved by (1, -0.7, 0.5)
    against that image, the light positions' scale 1 and every other
    group's 0, on this process's group; ``compiled(s, t)`` and
    ``eager(s, t)``: the compiled step (dist.make_train_step) and the eager
    one on any start and target; the start)."""
    from dataclasses import replace

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        render_image,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    cfg = RenderConfig(engine="megakernel")
    scene = build_scene(scenes.mount_scene(res=RES), device=dev)
    target = render_image(scene, cfg)
    moved = scene.lights.position.clone()
    moved[0] += torch.tensor([1.0, -0.7, 0.5], device=dev)
    start = replace(scene, lights=replace(scene.lights, position=moved))
    scales = dist.lr_scales(materials=0.0, light_pos=1.0, light_color=0.0,
                            camera=0.0)

    def eager(s, t):
        return dist.train_step_full(s, t, cfg, LIGHT_LR, None, scales)

    compiled = dist.make_train_step(dist.train_step_full, cfg, LIGHT_LR,
                                    scales=scales)
    return (scene, target, lambda: eager(start, target), compiled, eager,
            start)


def step_reading(step_out):
    """(loss, light positions on the host) of a train step's result."""
    new, loss = step_out
    return float(loss), new.lights.position.cpu()


def plant_fault(fault, rank):
    """Replace a piece of parallel/dist.py (or the graph cache under it) in
    this rank by ``fault`` (one of SHARD_FAULTS)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    if fault == SHARD_FAULTS[0] and rank == 1:
        sound = dist.gather_rows

        def early(part, n, start, group=None):
            return sound(part, n, start - 1, group)

        dist.gather_rows = early
    elif fault == SHARD_FAULTS[1]:
        dist.all_reduce_sum = lambda tensors, group=None: list(tensors)
    elif fault == SHARD_FAULTS[2]:
        sound_call = graphs.GraphCache.call
        first = {}

        def seeded_once(self, name, fn, args, generator=None, **kw):
            if name.startswith("dist.") and generator is not None:
                generator.set_state(first.setdefault(name,
                                                     generator.get_state()))
            return sound_call(self, name, fn, args, generator, **kw)

        graphs.GraphCache.call = seeded_once
    elif fault == SHARD_FAULTS[3]:
        sound_assemble = dist._assemble

        def one_row_early(blocks, n):
            full = sound_assemble(blocks, n)
            a, b = dist.shard_bounds(n, blocks.shape[0], 1)
            full[a - 1:b - 1] = blocks[1, :b - a]
            return full

        dist._assemble = one_row_early
    elif fault == SHARD_FAULTS[4]:
        from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
            pixel_grid,
        )

        sound_shard = dist._pixel_shard

        def traced_one_row_early(cam, device, group):
            px, py, n, start = sound_shard(cam, device, group)
            rank, size = dist.world(group)
            if rank != size - 1:
                return px, py, n, start
            gx, gy = pixel_grid(cam.res_x, cam.res_y, device)
            a = start - cam.res_x
            return gx[a:a + px.shape[0]], gy[a:a + px.shape[0]], n, start

        dist._pixel_shard = traced_one_row_early
    elif fault is not None and fault not in SHARD_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")


def frame_readings(eager, compiled, kernels_, on_card, timing):
    """A sharded frame path on this rank: the eager call's image and each
    kernel's launches (``counted``); the compiled calls (the first
    captures) against it, as the number of pixels that differ; the
    kernels' launches a replay counted on the card (``on_card``: the
    wrappers that run distinct device kernels); what the host issues a
    call, compiled and eager; with ``timing`` both calls' frame times."""
    img, n = counted(eager, kernels_)
    first = compiled()
    again, n_dev, reads = replay_launch_reads(compiled, on_card)
    rec = {"image": img.cpu(), "launches": n,
           "compiled_diff": [int((x != img).any(dim=-1).sum())
                             for x in (first, again)],
           "replay_launches": n_dev, "replay_reads": reads,
           "calls": {"compiled": host_calls(compiled),
                     "eager": host_calls(eager)}}
    if timing:
        rec["frame_ms"] = frame_times(eager)
        rec["compiled_ms"] = frame_times(compiled)
    return rec


def all_gather_check(img, rank, size):
    """On gloo: this rank's slice of the gathered image all-gathered again
    by dist.all_gather_rows on CPU tensors (the form NCCL takes; gloo has
    no all-gather of CUDA tensors), equal to the image or not; None on
    NCCL, whose frames went through it."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    if dist.backend_of() != "gloo":
        return None
    flat = img.reshape(-1, 3)
    a, b = dist.shard_bounds(flat.shape[0], size, rank)
    return torch.equal(dist.all_gather_rows(flat[a:b].cpu(), flat.shape[0]),
                       flat.cpu())


def sharded_rank(rank, size, parts=SHARD_PARTS, fault=None):
    """One rank of phases 30-32 and 35 (gloo ranks on cuda:0, NCCL ranks on
    cuda:rank), each path eager and compiled: mount_low 512x512, depth 4,
    on the megakernel engine (K1); the BVH field (the walk); one
    train_step_full of the light recovery at LIGHT_LR (K1; the compiled
    step held to the eager one by step_agreement, two chained steps);
    glsl_world's path-traced frame (K3). With "timing" in ``parts`` the
    frames and steps are timed, compiled and eager."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    dev = shard_setup()
    plant_fault(fault, rank)
    backend = dist.backend_of()
    out = {"rank": rank, "backend": backend, "device": str(dev),
           "collective_in_graph": dist.collective_in_graph()}
    if backend == "nccl":
        out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
    timing = "timing" in parts
    cfg_mk = RenderConfig(engine="megakernel")
    k1 = (kernels.whitted_megakernel,)
    if "mount" in parts or "train" in parts:
        mount, target, step, compiled, eager, start = light_step(dev)
    if "mount" in parts:
        out["mount"] = frame_readings(
            lambda: dist.render_image_sharded_eager(mount, cfg_mk),
            lambda: dist.render_image_sharded(mount, cfg_mk), k1, k1, timing)
        out["mount"]["all_gather"] = all_gather_check(out["mount"]["image"],
                                                      rank, size)
    if "field" in parts:
        field = build_scene(scenes.sphere_field_scene(n_side=FIELD_SIDE,
                                                      res=RES), device=dev)
        cfg = RenderConfig()
        out["field"] = frame_readings(
            lambda: dist.render_image_sharded_eager(field, cfg),
            lambda: dist.render_image_sharded(field, cfg),
            (kernels.bvh_closest, kernels.bvh_any, kernels.bvh_any_multi),
            (kernels.bvh_closest, kernels.bvh_any), timing)
    if "train" in parts:
        got, n = counted(step, k1)
        loss, light_pos = step_reading(got)
        agreement = step_agreement(compiled, eager, start, target)
        c_loss, c_pos = step_reading(compiled(start, target))
        _, n_dev, reads = replay_launch_reads(lambda: compiled(start, target),
                                              k1)
        out["train"] = {
            "loss": loss, "light_pos": light_pos, "launches": n,
            "compiled": {"agreement": agreement, "loss": c_loss,
                         "light_pos": c_pos, "replay_launches": n_dev,
                         "replay_reads": reads},
            "calls": {"compiled": host_calls(lambda: compiled(start, target),
                                             calls=2),
                      "eager": host_calls(step, calls=2)}}
        if timing:
            out["train"]["step_ms"] = frame_times(step, frames=SHARD_STEPS,
                                                  warmup=1)
            out["train"]["compiled_ms"] = frame_times(
                lambda: compiled(start, target), frames=SHARD_STEPS,
                warmup=1)
    if "pt" in parts:
        out["pt"] = sharded_pt(rank, size, dev, timing)
    return out


def sharded_pt(rank, size, dev, timing=False):
    """Phase 31 on one rank: glsl_world 512x512, 10 bounces. The eager
    frame without a generator (its launches, this rank's slice against the
    plain version on its own rays and uniforms); two compiled frames from
    one generator against two eager ones from another in the same state;
    K3's launches a replay counted on the card."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pathtracer as pt,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
        glsl_camera,
        glsl_world,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    world = glsl_world(device=dev)
    cam = glsl_camera(RES, RES, device=dev)
    cfg = pt.PTConfig()
    k3 = (kernels.pt_megakernel,)
    frame, n = counted(lambda: dist.pt_frame_sharded_eager(world, cam, cfg),
                       k3)
    a, b = dist.shard_bounds(RES * RES, size, rank)
    g = (dist.rank_generator(None, rank, size, dev)
         or torch.Generator(device=dev).manual_seed(0))
    px, py = pixel_grid(RES, RES, dev)
    rays = pt.camera_rays(cam, g, px[a:b], py[a:b])
    uni = pt.draw_uniforms(g, cfg.max_bounces, b - a)
    want = pt.ray_color_presampled(world, cfg, rays, uni)
    g, e = generator(dev, SHARD_PT_SEED), generator(dev, SHARD_PT_SEED)
    got = [dist.pt_frame_sharded(world, cam, cfg, None, g) for _ in range(2)]
    ref = [dist.pt_frame_sharded_eager(world, cam, cfg, None, e)
           for _ in range(2)]
    left = torch.equal(g.get_state(), e.get_state())
    _, n_dev, reads = replay_launch_reads(
        lambda: dist.pt_frame_sharded(world, cam, cfg, None, g), k3)
    rec = {"launches": n, "slice": (a, b), "mean": float(frame.mean()),
           "finite": bool(torch.isfinite(frame).all()),
           "agreement": pt_agreement(frame.reshape(-1, 3)[a:b], want),
           "compiled_diff": [int((x != y).any(dim=-1).sum())
                             for x, y in zip(got, ref)],
           "draws_anew": not torch.equal(got[0], got[1]),
           "generator_left": left,
           "replay_launches": n_dev, "replay_reads": reads,
           "calls": {"compiled": host_calls(
               lambda: dist.pt_frame_sharded(world, cam, cfg, None, g)),
               "eager": host_calls(
                   lambda: dist.pt_frame_sharded_eager(world, cam, cfg, None,
                                                       e))}}
    if timing:
        rec["frame_ms"] = frame_times(
            lambda: dist.pt_frame_sharded_eager(world, cam, cfg, None, e))
        rec["compiled_ms"] = frame_times(
            lambda: dist.pt_frame_sharded(world, cam, cfg, None, g))
    return rec


def sharded_rejects(results, refs):
    """Why the sharded checks of phases 30-32 and 35 reject the ranks'
    ``results`` against the single-process ``refs`` (empty: they pass).
    Eager: images bit-equal, the train step within SHARD_RTOL, the
    replicas equal, each kernel launched as the single process launches
    it, the path-traced frame of the ranks' slices within
    PT_LIMITS["glsl"] (pt_frame_agreement). Compiled: every
    replay's image bit-equal to the eager call's, the compiled step within
    GRAD_LIMIT of the eager step (step_agreement) and within SHARD_RTOL of
    the single process, the replicas equal, the path tracer's frames equal
    to the eager ones from the same generator (the second drawn anew, the
    generator left where eager leaves it), the launches a replay counted on
    the card (K1 1, the walk 4 + 8, K3 1); one graph launch a call; on
    NCCL no collective issued from the host in a compiled call; on gloo
    the slices all-gathered on the CPU equal to the frame."""
    why = []

    def calls_ok(rank, what, calls, nccl):
        c = calls["compiled"]
        if c["graph_launches"] != 1:
            why.append(f"rank {rank}: {what} {c['graph_launches']} graph "
                       "launches a compiled call")
        if nccl and c["collective_events"]:
            why.append(f"rank {rank}: {what} issued a collective from the "
                       "host in a compiled call")
        if not calls["eager"]["collective_events"]:
            why.append(f"rank {rank}: {what}: the profiler saw no "
                       "collective in the eager call, so its absence from "
                       "a compiled call says nothing")

    for r in results:
        rank, nccl = r["rank"], r["backend"] == "nccl"
        if "mount" in r:
            m = r["mount"]
            if not torch.equal(m["image"], refs["mount"]):
                why.append(f"rank {rank}: mount_low image differs")
            if m["launches"] != {"whitted_megakernel": 1}:
                why.append(f"rank {rank}: K1 launches {m['launches']}")
            if any(m["compiled_diff"]):
                why.append(f"rank {rank}: mount_low compiled frames differ "
                           f"from eager in {m['compiled_diff']} pixels")
            if m["replay_launches"] != {"whitted_megakernel": 1}:
                why.append(f"rank {rank}: K1 launches a replay "
                           f"{m['replay_launches']}")
            if m["all_gather"] is False:
                why.append(f"rank {rank}: the all-gather of the slices "
                           "differs from the frame")
            calls_ok(rank, "mount_low", m["calls"], nccl)
        if "field" in r:
            f = r["field"]
            if not torch.equal(f["image"], refs["field"]):
                why.append(f"rank {rank}: field image differs")
            if f["launches"] != {"bvh_closest": 4, "bvh_any": 8,
                                 "bvh_any_multi": 0}:
                why.append(f"rank {rank}: walk launches {f['launches']}")
            if any(f["compiled_diff"]):
                why.append(f"rank {rank}: field compiled frames differ from "
                           f"eager in {f['compiled_diff']} pixels")
            if f["replay_launches"] != {"bvh_closest": 4, "bvh_any": 8}:
                why.append(f"rank {rank}: walk launches a replay "
                           f"{f['replay_launches']}")
            calls_ok(rank, "field", f["calls"], nccl)
        if "train" in r:
            t, (loss, pos) = r["train"], refs["train"]
            c = t["compiled"]
            for label, (l_, p_) in (("", (t["loss"], t["light_pos"])),
                                    ("compiled ", (c["loss"],
                                                   c["light_pos"]))):
                if not np.allclose(l_, loss, rtol=SHARD_RTOL, atol=0):
                    why.append(f"rank {rank}: {label}loss {l_!r} against "
                               f"{loss!r}")
                if not torch.allclose(p_, pos, rtol=SHARD_RTOL, atol=0):
                    why.append(f"rank {rank}: {label}light positions differ "
                               f"by {float((p_ - pos).abs().max()):.3g}")
            if t["launches"] != {"whitted_megakernel": 1}:
                why.append(f"rank {rank}: step launches {t['launches']}")
            if c["replay_launches"] != {"whitted_megakernel": 1}:
                why.append(f"rank {rank}: step launches a replay "
                           f"{c['replay_launches']}")
            if c["agreement"]:
                why.append(f"rank {rank}: compiled step against eager: "
                           + "; ".join(c["agreement"]))
            first = results[0]["train"]
            if not (torch.equal(t["light_pos"], first["light_pos"])
                    and torch.equal(c["light_pos"],
                                    first["compiled"]["light_pos"])):
                why.append(f"rank {rank}: the replicas' lights differ")
            calls_ok(rank, "step", t["calls"], nccl)
        if "pt" in r:
            p = r["pt"]
            if not p["finite"]:
                why.append(f"rank {rank}: the path-traced frame is not "
                           "finite")
            if p["launches"] != {"pt_megakernel": 1}:
                why.append(f"rank {rank}: K3 launches {p['launches']}")
            if (any(p["compiled_diff"]) or not p["draws_anew"]
                    or not p["generator_left"]):
                why.append(f"rank {rank}: compiled path-tracer frames "
                           f"against eager: {p['compiled_diff']} pixels "
                           f"differ, drawn anew {p['draws_anew']}, the "
                           f"generator left as eager {p['generator_left']}")
            if p["replay_launches"] != {"pt_megakernel": 1}:
                why.append(f"rank {rank}: K3 launches a replay "
                           f"{p['replay_launches']}")
            calls_ok(rank, "path tracer", p["calls"], nccl)
    bad, mean = pt_frame_agreement(results)
    if bad is not None and (bad > PT_LIMITS["glsl"][0]
                            or mean > PT_LIMITS["glsl"][1]):
        why.append(f"path-traced frame against the plain version on the "
                   f"ranks' own draws: {bad * 100:.4f}% pixels beyond "
                   f"{ATOL}, mean abs diff {mean:.3g} (limits "
                   f"{PT_LIMITS['glsl']})")
    return why


def pt_frame_agreement(results):
    """(share of pixels beyond ATOL, mean abs difference) of the whole
    path-traced frame against the plain version, each rank's slice traced
    by it on that rank's rays and uniforms; (None, None) without a
    path-tracer reading. PT_LIMITS["glsl"] is the limit of a 512x512
    frame: a slice alone has 1/size of its pixels, so the few paths whose
    reflect/refract draw flips weigh size times more in it (one of four
    NCCL ranks read 0.0458% of its quarter beyond ATOL, 0.0114% of the
    frame)."""
    pts = [r["pt"] for r in results if "pt" in r]
    if not pts:
        return None, None
    sizes = [p["slice"][1] - p["slice"][0] for p in pts]
    n = sum(sizes)
    return (sum(p["agreement"][0] * k for p, k in zip(pts, sizes)) / n,
            sum(p["agreement"][1] * k for p, k in zip(pts, sizes)) / n)


def shard_refs(dev, mount_img, field_img=None):
    """The single-process references of the sharded checks: mount_low's
    and the field's images (phases 4 and 10; the field's None where no
    check reads it) and the light-recovery step's (loss, light positions);
    whether that step repeats bit for bit."""
    step = light_step(dev)[2]
    refs = {"mount": mount_img.cpu(),
            "field": None if field_img is None else field_img.cpu(),
            "train": step_reading(step())}
    again = step_reading(step())
    return refs, (again[0] == refs["train"][0]
                  and torch.equal(again[1], refs["train"][1]))


def shard_line(phase, r, card):
    """The printed readings of rank ``r``'s paths."""
    def calls(c):
        comp = c["compiled"]
        return (f"launch calls a call compiled {comp['launch_calls']:g} + "
                f"{comp['graph_launches']:g} graph, "
                f"{comp['collective_events']:g} collective events; "
                f"eager {c['eager']['launch_calls']:g}, "
                f"{c['eager']['collective_events']:g} collective events")

    def ms(x):
        if "compiled_ms" not in x:
            return ""
        (ce, cw), (ee, ew) = x["compiled_ms"], x.get("frame_ms",
                                                     x.get("step_ms"))
        return (f"; compiled {ce:.4f} ms CUDA events, {cw:.4f} ms host wall; "
                f"eager {ee:.4f} ms, {ew:.4f} ms ({card})")

    head = (f"{phase} rank {r['rank']} ({r['backend']}, {r['device']}, "
            f"collective in the graph {r['collective_in_graph']}"
            + (f", NCCL {r['nccl']}" if "nccl" in r else "") + ")")
    lines = []
    if "mount" in r:
        m = r["mount"]
        lines.append(
            f"{head}: mount_low {RES}x{RES} megakernel: eager launches "
            f"{m['launches']}, compiled frames' differing pixels "
            f"{m['compiled_diff']}, launches a replay on the card "
            f"{m['replay_launches']} (reads {m['replay_reads']}), "
            f"all-gather on the CPU equal {m['all_gather']}; "
            f"{calls(m['calls'])}{ms(m)}")
    if "field" in r:
        f = r["field"]
        lines.append(
            f"{head}: field{FIELD_SIDE}: eager launches {f['launches']}, "
            f"compiled differing pixels {f['compiled_diff']}, launches a "
            f"replay {f['replay_launches']}; {calls(f['calls'])}{ms(f)}")
    if "train" in r:
        t = r["train"]
        c = t["compiled"]
        lines.append(
            f"{head}: light step: eager loss {t['loss']!r}, light 0 at "
            f"{t['light_pos'][0].tolist()}, launches {t['launches']}; "
            f"compiled loss {c['loss']!r}, light 0 at "
            f"{c['light_pos'][0].tolist()}, against eager "
            f"{'; '.join(c['agreement']) or 'within GRAD_LIMIT'}, launches "
            f"a replay {c['replay_launches']}; {calls(t['calls'])}{ms(t)}")
    if "pt" in r:
        p = r["pt"]
        lines.append(
            f"{head}: glsl_world {RES}x{RES} 10 bounces pixels "
            f"[{p['slice'][0]}, {p['slice'][1]}), eager launches "
            f"{p['launches']}, slice against the plain version "
            f"{p['agreement'][0] * 100:.4f}% pixels beyond {ATOL}, mean abs "
            f"diff {p['agreement'][1]:.3g} (limits {PT_LIMITS['glsl']}); "
            f"compiled frames' differing pixels {p['compiled_diff']}, drawn "
            f"anew {p['draws_anew']}, generator left as eager "
            f"{p['generator_left']}, launches a replay "
            f"{p['replay_launches']}; {calls(p['calls'])}{ms(p)}; frame mean "
            f"{p['mean']:.6f}")
    return lines


def multicard_phase(card, refs):
    """Phase 35: one NCCL rank a card over every card of the box, up to
    SHARD_MAX_CARDS, rank r on cuda:r, the checks of phase 30 against the
    single process (``refs``); each rank's compiled and eager times and
    NCCL's version. Returns the ranks' results, or None (with one line
    saying why) on a box with one card."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import launch

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"35 NCCL across cards: not run: this box has {cards} card "
              "(the phase needs two or more; phases 30-32 ran the sharded "
              "paths on it)")
        return None
    n = min(cards, SHARD_MAX_CARDS)
    t0 = time.perf_counter()
    res = launch.run(sharded_rank, n, SHARD_PARTS + ("timing",),
                     backend="nccl", timeout_s=SHARD_TIMEOUT_S)
    for r in res:
        for line in shard_line("35", r, card):
            print(line)
    why = sharded_rejects(res, refs)
    bad, mean = pt_frame_agreement(res)
    print(f"35 NCCL across {n} of {cards} cards, one rank a card: the "
          f"path-traced frame of the slices against the plain version "
          f"{bad * 100:.4f}% pixels beyond {ATOL}, mean abs diff "
          f"{mean:.3g}; {'; '.join(why) or 'every check passed'} "
          f"({time.perf_counter() - t0:.1f} s)")
    if why:
        raise AssertionError("35: " + "; ".join(why))
    return res


def sharding_phases(dev, card, mount_img, field_img):
    """Phases 30-33 (see the module docstring), against phase 4's mount_low
    image and phase 10's field image; returns (the ranks' results, the
    sharded summary, the single-process frame and step times, the
    single-process path-traced frame's mean, the references)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
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
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        render_image,
    )

    cfg_mk = RenderConfig(engine="megakernel")
    world = glsl_world(device=dev)
    cam = glsl_camera(RES, RES, device=dev)
    pt_cfg = pt.PTConfig()
    # 30-31. the sharded paths: two gloo ranks on cuda:0 (parallel/launch),
    # each path eager and compiled (the render or the step's local part a
    # graph, gloo's collective after the replay): mount_low and the BVH
    # field against phases 4 and 10 bit for bit, the light-recovery step
    # against the single process's, glsl_world's path-traced frame; the
    # frames and steps timed on each rank
    t_shard = time.perf_counter()
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.image import preview_u8
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import launch

    m512, _, step, _, _, _ = light_step(dev)
    refs, step_repeats = shard_refs(dev, mount_img, field_img)
    shard = launch.run(sharded_rank, SHARD_RANKS, SHARD_PARTS + ("timing",),
                       backend="gloo", timeout_s=SHARD_TIMEOUT_S)
    single_ms = frame_times(lambda: render_image(m512, cfg_mk))
    single_step_ms = frame_times(step, frames=SHARD_STEPS, warmup=1)
    for r in shard:
        for line in shard_line("30-31", r, card):
            print(line)
    pt_single_mean = float(ptk.make_render_frame(world, cam, pt_cfg)(
        torch.Generator(device=dev).manual_seed(0)).mean())
    print(f"30 single process: frame {single_ms[0]:.4f} ms CUDA events, "
          f"{single_ms[1]:.4f} ms host wall (compiled); eager step "
          f"{single_step_ms[0]:.4f} ms CUDA events, {single_step_ms[1]:.4f} "
          f"ms host wall; the step repeats bit for bit {step_repeats}; "
          f"light step loss {refs['train'][0]!r}, light 0 at "
          f"{refs['train'][1][0].tolist()}; 31 single-process path-traced "
          f"frame mean {pt_single_mean:.6f} ({card})")
    bad, mean = pt_frame_agreement(shard)
    print(f"31 the ranks' path-traced frame against the plain version on "
          f"their own draws: {bad * 100:.4f}% pixels beyond {ATOL}, mean "
          f"abs diff {mean:.3g} (limits {PT_LIMITS['glsl']})")
    why = sharded_rejects(shard, refs)
    if why:
        raise AssertionError("30-31: " + "; ".join(why))

    # 32. NCCL at world size 1 in a child process: each path captured with
    # its collective inside the graph, against the eager call and the
    # single process's
    nccl = launch.run(sharded_rank, 1, SHARD_PARTS + ("timing",),
                      backend="nccl", timeout_s=SHARD_TIMEOUT_S)[0]
    for line in shard_line("32", nccl, card):
        print(line)
    nccl_img = torch.equal(nccl["mount"]["image"], refs["mount"])
    nccl_step = (nccl["train"]["loss"] == refs["train"][0] and torch.equal(
        nccl["train"]["light_pos"], refs["train"][1]))
    print(f"32 NCCL {nccl['nccl']}, world size 1: eager "
          f"render_image_sharded bit-equal {nccl_img}; eager train_step_full "
          f"bit-equal {nccl_step}; compiled calls one graph launch and no "
          "collective from the host each: "
          + str({k: nccl[k]["calls"]["compiled"] for k in SHARD_PARTS}))
    if not nccl_img or (step_repeats and not nccl_step):
        raise AssertionError("32: the NCCL rank's render or step differs "
                             "from the single process's")
    why = sharded_rejects([nccl], refs)
    if why:
        raise AssertionError(f"32: {why}")

    # 33. the front end on the card: cli orbit, view and live at 512x512
    # on the megakernel engine; preview_u8 on the card against the CPU
    cli = [sys.executable, "-m",
           "u_4a_2s_p3d_raytracer_template2_tpu_torch.cli"]
    common = ["--builtin", "mount", "--res", str(RES), "--engine",
              "megakernel"]
    front = {}
    for name, extra, keys in (
            ("orbit", ["--frames", "2", "-o", "build/orbit_%d.png"], None),
            ("view", ["--orbit-frames", "2", "--still-frames", "2", "-o",
                      "build/view.png"], None),
            ("live", ["--preview-cols", "80", "-o", "build/live.png"],
             "aw  a q")):
        t0 = time.perf_counter()
        out = subprocess.run(cli + [name] + common + extra, cwd=ROOT,
                             input=keys, capture_output=True, text=True,
                             check=True, timeout=300).stdout
        lines = [ln for ln in out.splitlines() if "\x1b[" not in ln]
        front[name] = {"seconds": time.perf_counter() - t0,
                       "lines": lines,
                       "preview_lines": len(out.splitlines()) - len(lines)}
        print(f"33 cli {name} ({front[name]['seconds']:.1f} s, "
              f"{front[name]['preview_lines']} preview lines):")
        for ln in lines:
            print(f"  {ln}")
    pngs = ["orbit_0.png", "orbit_1.png", "view.png", "live.png"]
    missing = [f for f in pngs if not (ROOT / "build" / f).exists()]
    fps_lines = {n: sum("FPS" in ln for ln in v["lines"])
                 for n, v in front.items()}
    accumulated = [ln.split()[1] for ln in front["live"]["lines"]
                   if ln.startswith("  accumulated")]
    # one graph for the orbit's frames, one for the accumulated ones: a
    # moving camera replays its graph
    captures = {n: [int(ln.split(":")[1]) for ln in v["lines"]
                    if ln.startswith("CUDA graphs captured:")]
                for n, v in front.items()}
    if (missing or fps_lines["view"] < 4 or fps_lines["live"] < 5
            or accumulated != ["1", "2", "1"]
            or front["live"]["preview_lines"] < 40
            or captures != {"orbit": [1], "view": [2], "live": [2]}):
        raise AssertionError(f"33: PNGs missing {missing}, FPS lines "
                             f"{fps_lines}, accumulated {accumulated}, "
                             f"captures {captures}")
    prev_dev = preview_u8(mount_img, 80)
    prev_cpu = preview_u8(mount_img.cpu(), 80)
    prev_err = int((prev_dev.cpu().int() - prev_cpu.int()).abs().max())
    print(f"33 preview_u8 {tuple(prev_dev.shape)} on {prev_dev.device} "
          f"against the CPU: max {prev_err} u8 levels")
    if prev_err > 1:
        raise AssertionError("33: preview_u8 on the card differs from the "
                             "CPU by more than 1 level")
    print(f"sharding and front-end phases "
          f"{time.perf_counter() - t_shard:.1f} s")
    sharded = {"ranks": SHARD_RANKS, "backend": "gloo, both on cuda:0",
               "nccl_world_1": {
                   "version": nccl["nccl"], "render_bit_equal": nccl_img,
                   "step_bit_equal": nccl_step,
                   "compiled_calls": {k: nccl[k]["calls"]["compiled"]
                                      for k in SHARD_PARTS},
                   "frame_ms": nccl["mount"]["frame_ms"],
                   "compiled_frame_ms": nccl["mount"]["compiled_ms"],
                   "step_ms": nccl["train"]["step_ms"],
                   "compiled_step_ms": nccl["train"]["compiled_ms"]}}
    return shard, sharded, single_ms, single_step_ms, pt_single_mean, refs


# Phase 34: the compiled programs (utils/graphs.py) against the eager
# functions they capture, at the headline sizes of PERF.md section 4.
GRAPH_FRAMES = 11     # timed frames a frame path: with the agreement, the
                      # profile and loop_ms, over 20 replays of one capture
GRAPH_PROFILE = 5     # frames a path under the profiler
GRAPH_STEPS = 4       # timed train steps a step path (2 profiled)
ORBIT_FRAMES = 16
# planted faults phase 34's checks must reject (chip_faults.py)
GRAPH_FAULTS = ("the graph's generator is not registered",
                "every replay restarts from the capture's draws",
                "the camera is not copied in",
                "the capture packs the megakernel tables into the caller's "
                "Scene.cache, with no warm-up",
                "the train step's graph returns the scene it was given, "
                "its update lost")


def generator(dev, seed=None, state=None):
    """A generator on ``dev`` seeded ``seed`` or in ``state``."""
    g = torch.Generator(device=dev)
    if state is not None:
        g.set_state(state)
    else:
        g.manual_seed(seed)
    return g


def orbit_scene(scene, alpha, beta=10.0):
    """``scene`` with its camera moved on cli orbit's orbit to yaw
    ``alpha`` degrees (a new Scene from dataclasses.replace)."""
    from dataclasses import replace

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        orbit_eye,
        with_eye,
    )

    cam = scene.camera
    r = float(torch.linalg.vector_norm(cam.eye))
    return replace(scene, camera=with_eye(cam, orbit_eye(cam, alpha, beta,
                                                         r)))


def drifted_scene(scene, i):
    """``scene`` with its eye moved by i·1e-5 of itself (the view of the
    headline frame, a new input each frame: the timed frames of phase 34)."""
    from dataclasses import replace

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        with_eye,
    )

    cam = scene.camera
    return replace(scene, camera=with_eye(cam, cam.eye * (1.0 + 1e-5 * i)))


def moved_scene(scene):
    """Another input of one structure: the camera moved 15 degrees and the
    lights at 0.8 of their colour (a table value, packed per replay)."""
    from dataclasses import replace

    s = orbit_scene(scene, 15.0)
    return replace(s, lights=replace(s.lights, color=s.lights.color * 0.8))


def whitted_path(scene, cfg):
    """(compiled, eager, inputs) of a Whitted frame: render_image (one
    graph replay on the card) against the eager render_tile over the
    frame; inputs two fresh seeds and a generator already advanced by one
    frame, the second seed on ``moved_scene``."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
        render_image,
        render_tile,
    )

    cam = scene.camera
    dev = scene.device
    px, py = pixel_grid(cam.res_x, cam.res_y, dev)

    def compiled(s, g):
        return render_image(s, cfg, g)

    def eager(s, g):
        return render_tile(s, px, py, cfg, g).reshape(cam.res_y, cam.res_x,
                                                      3)

    advanced = generator(dev, 2)
    eager(scene, advanced)
    return compiled, eager, [(scene, generator(dev, 1)), (scene, advanced),
                             (moved_scene(scene), generator(dev, 3))]


def replay_agreement(compiled, eager, inputs):
    """Why the compiled calls disagree with the eager function on
    ``inputs`` [(x, generator)] (empty: they agree). Every compiled call
    runs first, then the eager calls from the generators' states before
    them, so that an eager call reads whatever a capture left in a cache
    after other inputs' replays. Outputs bit for bit; each generator left
    where the eager call leaves it."""
    starts = [g.get_state() for _, g in inputs]
    got = [compiled(x, g) for x, g in inputs]
    why = []
    for i, ((x, g), state, a) in enumerate(zip(inputs, starts, got)):
        e = generator(g.device, state=state)
        b = eager(x, e)
        if not torch.equal(a, b):
            why.append(f"input {i}: {int((a != b).any(dim=-1).sum())} "
                       f"pixels differ, max abs "
                       f"{float((a - b).abs().max()):.3g}")
        if not torch.equal(g.get_state(), e.get_state()):
            why.append(f"input {i}: the generator is left elsewhere than "
                       "the eager call leaves it")
    return why


def orbit_agreement(scene, cfg, frames=ORBIT_FRAMES):
    """Why a compiled orbit of ``frames`` frames (the camera moved each
    frame, cli orbit's loop) fails: a frame unequal to the eager one, or
    other than one capture. Starts from an empty graph cache."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    compiled, eager, _ = whitted_path(scene, cfg)
    graphs.CACHE.clear()
    n0 = graphs.CACHE.captures
    dev = scene.device
    scenes = [orbit_scene(scene, 360.0 * i / frames) for i in range(frames)]
    got = [compiled(s, generator(dev, i)) for i, s in enumerate(scenes)]
    captures = graphs.CACHE.captures - n0
    why = [] if captures == 1 else [f"{captures} captures, not 1"]
    bad = [i for i, (s, a) in enumerate(zip(scenes, got))
           if not torch.equal(a, eager(s, generator(dev, i)))]
    if bad:
        why.append(f"frames {bad} differ from the eager frames")
    return why, captures


def pt_agreement_progressive(world, cam, cfg, frames=PT_FRAMES):
    """Why ``frames`` compiled progressive path-tracer frames differ from
    the eager ones from one seed (empty: bit-equal)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pathtracer as pt,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pt_megakernel as ptk,
    )

    tables = ptk.pt_tables(world)
    dev = world.device
    got = pt.render_progressive(world, cam, cfg, generator(dev, 11), frames,
                                frame_fn=ptk.make_render_frame(world, cam,
                                                               cfg))
    want = pt.render_progressive(
        world, cam, cfg, generator(dev, 11), frames,
        frame_fn=lambda g: ptk.render_frame_megakernel(tables, cam, cfg, g))
    if torch.equal(got.sum_linear, want.sum_linear):
        return []
    return [f"{frames} progressive frames differ: max abs "
            f"{float((got.sum_linear - want.sum_linear).abs().max()):.3g}"]


def train_setup(dev, engine, res=RES):
    """Phase 27's fits on mount_low at ``res``, depth 4: (start, target,
    cfg, lr, scales): on the megakernel engine the light recovery at
    LIGHT_LR, on the wavefront fit --fit all at BENCH_LR; light 0 moved by
    (1, -0.7, 0.5)."""
    from dataclasses import replace

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        render_image,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    cfg = RenderConfig(engine=engine)
    scene = build_scene(scenes.mount_scene(res=res), device=dev)
    target = render_image(scene, cfg)
    moved = scene.lights.position.clone()
    moved[0] += torch.tensor([1.0, -0.7, 0.5], device=dev)
    start = replace(scene, lights=replace(scene.lights, position=moved))
    lr = LIGHT_LR if engine == "megakernel" else BENCH_LR
    scales = dist.lr_scales(materials=0.0, light_pos=1.0, light_color=0.0,
                            camera=0.0 if engine == "megakernel" else 1.0)
    return start, target, cfg, lr, scales


def step_agreement(compiled, eager, start, target, steps=2):
    """Why ``steps`` chained compiled train steps disagree with the eager
    ones (empty: they agree): the loss, every parameter leaf and every
    leaf's update within GRAD_LIMIT of the eager step's (GRAD_LIMIT[0] of
    the largest magnitude, plus GRAD_LIMIT[1]). The compiled chain runs
    first."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    def chain(step):
        out, s = [], start
        for _ in range(steps):
            new, loss = step(s, target)
            out.append((s, new, loss))
            s = new
        return out

    got, want = chain(compiled), chain(eager)
    why = []

    def within(what, a, b):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        if not err <= GRAD_LIMIT[0] * scale + GRAD_LIMIT[1]:
            why.append(f"{what}: off by {err:.3g} (scale {scale:.3g})")

    for i, ((a0, a, la), (b0, b, lb)) in enumerate(zip(got, want)):
        within(f"step {i} loss", la, lb)
        for j, (pa0, pa, pb0, pb) in enumerate(zip(
                dist.tree_leaves(dist.params_of(a0)),
                dist.tree_leaves(dist.params_of(a)),
                dist.tree_leaves(dist.params_of(b0)),
                dist.tree_leaves(dist.params_of(b)))):
            within(f"step {i} leaf {j}", pa, pb)
            within(f"step {i} leaf {j}'s update", pa - pa0, pb - pb0)
    return why


def graph_checks(dev, res):
    """Phase 34's agreement checks at ``res`` (the ones chip_faults.py
    plants GRAPH_FAULTS under, and the card tests run at 64x64), each a
    list of reasons (empty: it passes): mount_low's megakernel frame, its
    distribution frame (spp 2, soft shadows, fuzzy reflection, a synthetic
    cubemap), the 16-frame orbit, 16 progressive path-tracer frames of
    glsl_world, and the megakernel train step."""
    from dataclasses import replace

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pathtracer as pt,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
        glsl_camera,
        glsl_world,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    cfg = RenderConfig(engine="megakernel")
    mount = build_scene(scenes.mount_scene(res=res), device=dev)
    out = {}
    graphs.CACHE.clear()
    out["mount"] = replay_agreement(*whitted_path(mount, cfg))
    dscene = replace(mount, spp=2, skybox=synthetic_cubemap(dev),
                     has_skybox=True)
    dcfg = RenderConfig(engine="megakernel", soft_shadow=True,
                        fuzzy_reflection=True,
                        use_skybox=True).with_scene_flags(dscene)
    out["distribution"] = replay_agreement(*whitted_path(dscene, dcfg))
    out["orbit"] = orbit_agreement(mount, cfg)[0]
    world = glsl_world(device=dev)
    out["pt"] = pt_agreement_progressive(world, glsl_camera(res, res,
                                                            device=dev),
                                         pt.PTConfig())
    start, target, tcfg, lr, sc = train_setup(dev, "megakernel", res)
    step = dist.make_train_step(dist.train_step_full, tcfg, lr, scales=sc)
    out["step"] = step_agreement(
        step, lambda s, t: dist.train_step_full(s, t, tcfg, lr, None, sc),
        start, target)
    graphs.CACHE.clear()
    return out


def graph_path(label, compiled, eager, inputs, xs, card, counted,
               frames=GRAPH_FRAMES, profiled=GRAPH_PROFILE,
               loop=(2, 6, 3), check=None):
    """One path of phase 34 from an empty graph cache: the first compiled
    call (warm-up and capture: host ms, the capture's own ms, the pool's
    MiB, max_memory_allocated before and after), the agreement (``check``
    on (compiled, eager, inputs), replay_agreement by default), the
    kernels' launches a compiled call (replay_launches: counted on the
    device), then for the compiled and the eager function: launch calls,
    graph launches, device ops and idle share under the profiler,
    CUDA-event and host-wall frame ms (medians of ``frames``), loop_ms;
    the captures over every compiled call, required to be 1. ``xs``: the
    timed inputs (a drifting camera or target), each call with a
    generator of its own seed. Returns a record."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.timing import (
        loop_ms,
    )

    graphs.CACHE.clear()
    torch.cuda.synchronize()
    dev = torch.device("cuda", 0)
    n0 = graphs.CACHE.captures
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.max_memory_allocated(dev) / 2**20
    t0 = time.perf_counter()
    compiled(xs[0], generator(dev, 999))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    mem1 = torch.cuda.max_memory_allocated(dev) / 2**20
    [graph] = graphs.CACHE.graphs.values()
    why = (check or replay_agreement)(compiled, eager, inputs)
    _, n, reads = replay_launch_reads(
        lambda: compiled(xs[0], generator(dev, 998)), counted)
    launches = {k: v for k, v in n.items() if v}
    rec = {"label": label, "first_call_ms": first_ms,
           "capture_ms": graph.capture_ms, "pool_mib": graph.pool_mib,
           "max_allocated_mib": (mem0, mem1), "agreement": why,
           "launches": launches,
           "launch_reads": [{k: r[k] for k in launches} for r in reads]}
    for mode, fn in (("compiled", compiled), ("eager", eager)):
        def call(i, fn=fn):
            return fn(xs[i % len(xs)], generator(dev, 1000 + i))

        prof = profile_frames(f"34 {label} {mode}", call, lambda i: (i,),
                              card, frames=profiled)
        it = iter(range(10**6))
        ev_ms, wall_ms = frame_times(lambda: call(next(it)), frames=frames,
                                     warmup=1)
        rec[mode] = {"profile": prof, "cuda_ms": ev_ms, "wall_ms": wall_ms,
                     "loop_ms": loop_ms(call, *loop)}
    rec["captures"] = graphs.CACHE.captures - n0
    rec["replays"] = graph.replays
    c, e = rec["compiled"], rec["eager"]
    print(f"34 {label}: agreement {'ok' if not why else why}; captures "
          f"{rec['captures']} over {graph.replays} replays; launches a "
          f"compiled call {launches} (the most of three counted calls: "
          f"{rec['launch_reads']}); launch calls a call (profiler) "
          f"compiled {c['profile'].get('launch_calls')} + "
          f"{c['profile'].get('graph_launches')} graph, eager "
          f"{e['profile'].get('launch_calls')}; device idle compiled "
          f"{c['profile'].get('idle')}, eager {e['profile'].get('idle')}; "
          f"CUDA-event ms compiled {c['cuda_ms']:.4f}, eager "
          f"{e['cuda_ms']:.4f}; host wall ms compiled {c['wall_ms']:.4f}, "
          f"eager {e['wall_ms']:.4f}; loop_ms compiled {c['loop_ms']:.4f}, "
          f"eager {e['loop_ms']:.4f}; first call {first_ms:.1f} ms, capture "
          f"{graph.capture_ms:.1f} ms, pool {graph.pool_mib:.1f} MiB, "
          f"max allocated {mem0:.1f} -> {mem1:.1f} MiB ({card})")
    graphs.CACHE.clear()
    return rec


def graph_phase(dev, card, dscene, dcfg, field, field_nb, g_field):
    """Phase 34 (see the module docstring): the compiled programs at the
    headline sizes, on phase 17's distribution scene and config, the BVH
    and brute fields of phases 10 and 13 and the grid field of phase 25;
    raises on a failed check and returns the summary it prints."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pathtracer as pt,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pt_megakernel as ptk,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
        glsl_camera,
        glsl_world,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    # each path's replays against its eager function, its captures, the
    # host's launch calls, the device's idle share, and compiled and eager
    # times; the 16-frame orbit and 16 progressive path-tracer frames
    t_graph = time.perf_counter()
    cfg_mk = RenderConfig(engine="megakernel")
    cfg_bvh = RenderConfig()
    cfg_wf = RenderConfig(engine="wavefront")
    world = glsl_world(device=dev)
    cam = glsl_camera(RES, RES, device=dev)
    pt_cfg = pt.PTConfig()
    n_sub = max(dcfg.spp, 1) ** 2 if dcfg.anti_aliasing else 1
    counted34 = (kernels.bvh_closest, kernels.bvh_any,
                 kernels.brute_closest, kernels.brute_any,
                 kernels.whitted_megakernel, kernels.pt_megakernel,
                 *perray_kernels())
    cfg_pr = RenderConfig(accel_impl="perray")
    cfg_if = RenderConfig(accel_impl="perray",
                          reference_grid_shadow_initfail=True)

    mount34 = build_scene(scenes.mount_scene(res=RES), device=dev)
    walk12 = {"bvh_closest": 4, "bvh_any": 8}
    brute12 = {"brute_closest": 4, "brute_any": 8}
    median12 = {"perray_bvh_closest": 4, "perray_bvh_any": 8}
    dda12 = {"grid_closest": 4, "grid_any": 8}
    graph_recs, expected = {}, {}
    for label, gscene, gcfg, want in (
            ("mount_low megakernel", mount34, cfg_mk,
             {"whitted_megakernel": 1}),
            ("distribution frame", dscene, dcfg,
             {"whitted_megakernel": n_sub}),
            ("BVH field sweep", field, cfg_bvh, walk12),
            ("BVH field wavefront (W1)", field, cfg_wf, walk12),
            ("brute field sweep", field_nb, cfg_bvh, brute12),
            ("brute field wavefront (W2)", field_nb, cfg_wf, brute12),
            ("P1 perray median BVH field", field, cfg_pr, median12),
            ("P2 perray grid DDA field", g_field, cfg_pr, dda12),
            ("P2q grid DDA field, reference_grid_shadow_initfail", g_field,
             cfg_if, dda12)):
        xs = [drifted_scene(gscene, i) for i in range(16)]
        graph_recs[label] = graph_path(label, *whitted_path(gscene, gcfg),
                                       xs, card, counted34)
        expected[label] = want

    def pt_compiled(c, g):
        return ptk.make_render_frame(world, c, pt_cfg)(g)

    def pt_eager(c, g):
        return ptk.render_frame_megakernel(ptk.pt_tables(world), c, pt_cfg,
                                           g)

    pt_adv = generator(dev, 2)
    pt_eager(cam, pt_adv)
    dof_cam = glsl_camera(RES, RES, showcase_dof=True, device=dev)
    graph_recs["glsl_world path tracer"] = graph_path(
        "glsl_world path tracer", pt_compiled, pt_eager,
        [(cam, generator(dev, 1)), (cam, pt_adv),
         (dof_cam, generator(dev, 3))], [cam], card, counted34)
    expected["glsl_world path tracer"] = {"pt_megakernel": 1}

    def ptp_compiled(c, g):
        return ptk.make_render_frame(world, c, pt_cfg, "plain")(g)

    def ptp_eager(c, g):
        return pt.render_frame(world, c, pt_cfg, g)

    ptp_adv = generator(dev, 2)
    ptp_eager(cam, ptp_adv)
    # the plain engine's frame is device-bound at ~0.19 s: fewer timed
    # frames (still 20 or more replays of its one capture)
    graph_recs["glsl_world path tracer, plain engine"] = graph_path(
        "glsl_world path tracer, plain engine", ptp_compiled, ptp_eager,
        [(cam, generator(dev, 1)), (cam, ptp_adv),
         (dof_cam, generator(dev, 3))], [cam], card, counted34, frames=3,
        profiled=2, loop=(1, 4, 2))
    expected["glsl_world path tracer, plain engine"] = {}
    for engine, want in (("megakernel", {"whitted_megakernel": 1}),
                         ("wavefront", {})):
        start, target, tcfg, lr, sc = train_setup(dev, engine)
        step = dist.make_train_step(dist.train_step_full, tcfg, lr,
                                    scales=sc)

        def step_compiled(x, g, step=step):
            return step(x[0], x[1], g)

        def step_eager(x, g, tcfg=tcfg, lr=lr, sc=sc):
            return dist.train_step_full(x[0], x[1], tcfg, lr, g, sc)

        def step_check(c, e, _, start=start, target=target):
            return step_agreement(lambda s, t: c((s, t), None),
                                  lambda s, t: e((s, t), None), start,
                                  target)

        label = f"train step {engine}"
        graph_recs[label] = graph_path(
            label, step_compiled, step_eager, None,
            [(start, target + 1e-7 * i) for i in range(GRAPH_STEPS)], card,
            counted34, frames=GRAPH_STEPS, profiled=2, loop=(1, 4, 2),
            check=step_check)
        expected[label] = want
        del start, target, step
    orbit_why, orbit_captures = orbit_agreement(mount34, cfg_mk)
    print(f"34 orbit: mount_low {RES}x{RES} megakernel, {ORBIT_FRAMES} "
          f"frames with the camera moving, {orbit_captures} capture(s); "
          f"every frame bit-equal to eager {not orbit_why}")
    pt_why = pt_agreement_progressive(world, cam, pt_cfg)
    print(f"34 path tracer: {PT_FRAMES} progressive compiled frames "
          f"bit-equal to {PT_FRAMES} eager ones {not pt_why}")
    graphs.CACHE.clear()
    failed = {k: r["agreement"] for k, r in graph_recs.items()
              if r["agreement"]}
    failed.update({f"{k} captures": r["captures"] for k, r in
                   graph_recs.items()
                   if r["captures"] != 1 or r["replays"] < 20})
    failed.update({f"{k} launches": r["launches"]
                   for k, r in graph_recs.items()
                   if r["launches"] != expected[k]})
    if orbit_why:
        failed["orbit"] = orbit_why
    if pt_why:
        failed["progressive"] = pt_why
    summary = {k: {"captures": r["captures"], "replays": r["replays"],
                   "launches": r["launches"],
                   "capture_ms": r["capture_ms"], "pool_mib": r["pool_mib"],
                   "max_allocated_mib": r["max_allocated_mib"],
                   **{m: {"cuda_ms": r[m]["cuda_ms"],
                          "wall_ms": r[m]["wall_ms"],
                          "loop_ms": r[m]["loop_ms"],
                          **{q: r[m]["profile"].get(q) for q in (
                              "launch_calls", "graph_launches", "idle",
                              "busy_ms", "device_ops")}}
                      for m in ("compiled", "eager")}}
               for k, r in graph_recs.items()}
    print("34 summary " + json.dumps({"card": card, "paths": summary,
                                      "orbit_captures": orbit_captures}))
    print(f"graph phase {time.perf_counter() - t_graph:.1f} s")
    if failed:
        raise AssertionError(f"34: {failed}")
    return summary


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
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import (
        checkpoint,
        graphs,
    )
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
             "brute_intersect", "probes", "perray_traverse")

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

    # 4. main path through the entry points a user calls; render_image on
    # the card replays the frame's CUDA graph (utils/graphs.py), captured
    # by a first frame; the replay's launches are counted on the device
    probe_kernels = (kernels.op_rate, kernels.fma_peak, kernels.stack_walk)
    render_image(scene, cfg_mk)
    img, n = replay_launches(lambda: render_image(scene, cfg_mk),
                             (kernels.whitted_megakernel,) + probe_kernels)
    launches = n["whitted_megakernel"]
    probe_launches = [n[k.__name__] for k in probe_kernels]
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
    mount_img = img  # phase 30's single-process reference
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
          f"per ray; a warp's deepest ray "
          f"{32 * ww['warp_nodes'] / o.shape[0]:.3f}, lanes busy "
          f"{ww['tests'] / (32 * ww['warp_nodes']):.3f}), {ww['hits']} hits, "
          f"{ww['pairs']} hit-light pairs, "
          f"{ww['feelers']} shadow rays testing {ww['tri_tests']} triangles "
          f"and {ww['sph_tests']} spheres; {w_flops / 1e9:.4f} GFLOP, "
          f"{w_bytes / 1e6:.4f} MB; bound {w_bound_ms:.5f} ms ({w_bound_by})")

    graphs.CACHE.clear()  # the graphs so far and their memory pools
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
    frame_fn(torch.Generator(device=dev).manual_seed(99))  # the capture
    acc, n = replay_launches(lambda: pt.render_progressive(
        world, cam, pt_cfg, torch.Generator(device=dev).manual_seed(0),
        n_frames=PT_FRAMES, frame_fn=frame_fn), (kernels.pt_megakernel,))
    image = pt.to_image(acc)
    pt_launches = n["pt_megakernel"]
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
          f"{pw['tests'] / R:.4f} live bounces per path (a warp's longest "
          f"{32 * pw['warp_bounces'] / R:.4f}, lanes busy "
          f"{pw['tests'] / (32 * pw['warp_bounces']):.4f}), "
          f"{pw['hits'] / R:.4f} "
          f"hits per path (diffuse, metal, dielectric {pw['hits_by_type']}); "
          f"{pw['pairs']} hit-light pairs, {pw['feelers']} feelers testing "
          f"{pw['sph_tests']} spheres and {pw['tri_tests']} triangles; "
          f"{pt_flops / 1e9:.4f} GFLOP, {pt_bytes / 1e6:.4f} MB; bound "
          f"{pt_bound_ms:.5f} ms ({pt_bound_by})")
    print(f"path-tracer phases {time.perf_counter() - t_pt:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    graphs.CACHE.clear()  # the graphs so far and their memory pools
    # 9. BVH walk: kernels against plain on the same rays
    t_bvh = time.perf_counter()
    bvh_err = {"closest": 0.0, "any": 0.0, "multi": 0.0}
    for label, tables, query, args in bvh_cases(dev):
        got = bvh_run(query, tables, args, poison=True)
        want = bvh_run(query, tables, args, kernel=False)
        torch.cuda.synchronize()
        reading = live_agreement(query, got, want, dead_of(query, args))
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
    # on the device bvh_any and bvh_any_multi are one kernel (any_kernel):
    # a frame's any-hit launches read as bvh_any's, a fused frame's as
    # bvh_any_multi's
    walk_kernels = (kernels.bvh_closest, kernels.bvh_any)
    render_image(field, cfg_bvh)  # the capture
    img, n = replay_launches(lambda: render_image(field, cfg_bvh),
                             walk_kernels)
    field_img = img  # phase 30's single-process reference
    bvh_launches = [n["bvh_closest"], n["bvh_any"]]
    print(f"main path: render_image field{FIELD_SIDE} ({field.n_objects} "
          f"objects, {field.packets.nodes.shape[0]} nodes, depth "
          f"{field.packets.depth}) {RES}x{RES} depth {cfg_bvh.max_depth} "
          f"accel bvh, launches closest/any {bvh_launches}")
    if bvh_launches[0] < 1 or bvh_launches[1] < 1:
        raise AssertionError("the BVH main path did not launch the walk")
    if img.shape != (RES, RES, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad BVH image: {tuple(img.shape)}")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("BVH image outside [0, 1]")
    print(f"BVH image mean {float(img.mean()):.5f}")
    save_png(str(ROOT / "build" / "field_smoke.png"), img)
    render_image(field, RenderConfig(accel_impl="multi"))  # the capture
    img_multi, n = replay_launches(
        lambda: render_image(field, RenderConfig(accel_impl="multi")),
        (kernels.bvh_closest, kernels.bvh_any_multi))
    multi_launches = n["bvh_any_multi"]
    print(f"main path, accel_impl='multi': launches closest/multi "
          f"{[n['bvh_closest'], multi_launches]}")
    if not 1 <= multi_launches < bvh_launches[1]:
        raise AssertionError(f"accel_impl='multi' launched the any-hit "
                             f"walk {multi_launches} times: want one fused "
                             f"launch a level, fewer than "
                             f"{bvh_launches[1]}")
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

    # 11. BVH timing: each of the frame's 12 walk launches alone on the
    # sweep's own queries and dead masks (frame_queries) of drifting frames,
    # and the fused multi-light launch on level 0's; its plain version; its
    # bound from the kernel's own work counters; whole frames
    bvh_inputs = [frame_queries(field, *camera_rays(field, 0.37 * i),
                                cfg_bvh) for i in range(7)]
    levels = len(bvh_inputs[0][0])
    n_lights = len(bvh_inputs[0][1]) // levels

    def fused(x):
        q = x[1][:n_lights]
        return (q[0][0], torch.stack([s[1] for s in q]), q[0][2],
                torch.stack([s[3] for s in q]))

    timed = ([(f"closest, level {lvl}", "closest",
               lambda x, lvl=lvl: x[0][lvl]) for lvl in range(levels)]
             + [(f"any, level {lvl}, light {li}", "any",
                 lambda x, k=lvl * n_lights + li: x[1][k])
                for lvl in range(levels) for li in range(n_lights)]
             + [("multi, level 0, both lights", "multi", fused)])
    pk = field.packets
    bvh_times = {}
    for label, query, pick in timed:
        args = [(pk, *pick(x)) for x in bvh_inputs]
        k_ms = queued_ms(lambda *a: bvh_run(query, a[0], a[1:]), args)
        call_ms = cuda_ms(lambda *a: bvh_run(query, a[0], a[1:]), args)
        p_ms = cuda_ms(lambda *a: bvh_run(query, a[0], a[1:], kernel=False),
                       args[:2], warmup=1)
        print(f"bvh {label}: kernel {k_ms:.4f} ms on the device ({call_ms:.4f} "
              f"ms a call from an idle device, host included), plain "
              f"{p_ms:.4f} ms ({args[0][1].shape[0]} slots, field{FIELD_SIDE} "
              f"{RES}x{RES}, {card})")
        bvh_times[label] = (k_ms, p_ms, bvh_work(query, pk, args[0][1:]))
    del bvh_inputs
    walk_frame = {}
    for query, n in (("closest", levels), ("any", levels * n_lights)):
        rows = [v for k, v in bvh_times.items() if k.startswith(query)]
        walk_frame[query] = {"launches": n, "ms": sum(v[0] for v in rows),
                             "bound_ms": sum(v[2][2] for v in rows),
                             "by_launch_ms": [v[0] for v in rows]}
    walk_ms = sum(v["ms"] for v in walk_frame.values())
    print(f"bvh the frame's {levels + levels * n_lights} walk launches: "
          f"{walk_ms:.4f} ms on the device (closest "
          f"{walk_frame['closest']['ms']:.4f}, any "
          f"{walk_frame['any']['ms']:.4f}) against a bound of "
          f"{sum(v['bound_ms'] for v in walk_frame.values()):.5f} ms ({card})")
    bvh_ms = frame_ms(field, cfg_bvh)
    print(f"frame BVH sweep: {bvh_ms:.4f} ms, {mrays_per_s(field, bvh_ms):.2f} "
          f"Mrays/s (primary+shadow), field{FIELD_SIDE} {RES}x{RES} depth "
          f"{cfg_bvh.max_depth}, {card}")
    bvh_prof = profile_frames(
        f"BVH frame, sweep engine, field{FIELD_SIDE} {RES}x{RES}",
        render_tile, lambda i: (field, px + 0.37 * i, py, cfg_bvh), card,
        frames=5, share_of=("closest_kernel", "any_kernel"))
    print(f"BVH phases {time.perf_counter() - t_bvh:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    graphs.CACHE.clear()  # the graphs so far and their memory pools
    # 12. brute force: the kernels against their plain version on the same
    # rays, into poisoned outputs
    t_brute = time.perf_counter()
    brute_err = {"closest": 0.0, "any": 0.0}
    for label, prims, tables, query, args in brute_cases(dev):
        dead = dead_of(query, args)
        got = brute_run(query, tables, args, poison=True)
        want = brute_plain(query, prims, args)
        torch.cuda.synchronize()
        reading = live_agreement(query, got, want, dead)
        print(f"compare {label} ({query}, {args[0].shape[0]} slots, "
              f"{live_of(dead, args[0].shape[0])} live): "
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
        render_image(scene, cfg_bvh)  # the capture
        image, n = replay_launches(lambda: render_image(scene, cfg_bvh),
                                   brute_kernels + walk_kernels)
        counts = ([n[k.__name__] for k in brute_kernels],
                  [n[k.__name__] for k in walk_kernels])
        print(f"main path: render_image {label} ({scene.n_objects} objects) "
              f"{RES}x{RES} depth {cfg_bvh.max_depth} accel none, launches "
              f"brute closest/any {counts[0]}, walk closest/any "
              f"{counts[1]}")
        if counts != ([4, 8], [0, 0]):
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

    # 14. brute-force timing: each kernel alone on the frame's own queries
    # (with the masks the sweep hands them) of drifting frames, and on the
    # soup's, per table mix; its plain version on one batch; its bound from
    # the plain version's count of its work; whole frames and a profile
    sph_prims = subset(field_nb.prims, tri=False)
    sph_tb = intersect.brute_tables(sph_prims)
    soup_nb = build_scene(soup_scene(res=RES), device=dev,
                          accel=C.ACCEL_NONE)
    tri_prims = subset(soup_nb.prims, sph=False)
    tri_tb = intersect.brute_tables(tri_prims)
    field_q = [frame_queries(field_nb, *camera_rays(field_nb, 0.37 * i),
                             cfg_bvh) for i in range(7)]
    soup_q = [frame_queries(soup_nb, *camera_rays(soup_nb, 0.37 * i),
                            cfg_bvh) for i in range(7)]
    levels = len(field_q[0][0])
    n_lights = len(field_q[0][1]) // levels
    for lvl, (q, _, dead) in enumerate(field_q[0][0]):
        live = live_of(dead, q.shape[0])
        print(f"live slots, field{FIELD_SIDE} {RES}x{RES} level {lvl}: "
              f"{live} of {q.shape[0]} ({100 * live / q.shape[0]:.2f}%)")
    timed = (
        [(f"closest, level {lvl}, main table" + (" (K4b)" if lvl == 0
                                                  else ""),
          "closest", field_nb.prims, field_nb.brute, field_q,
          lambda x, lvl=lvl: x[0][lvl]) for lvl in range(levels)]
        + [(f"any, level {lvl}, light {li}, main table", "any",
            field_nb.prims, field_nb.brute, field_q,
            lambda x, k=lvl * n_lights + li: x[1][k])
           for lvl in range(levels) for li in range(n_lights)]
        + [("closest, level 0, field spheres (K4a)", "closest", sph_prims,
            sph_tb, field_q, lambda x: x[0][0]),
           ("any, level 0, light 0, field spheres (K4c)", "any", sph_prims,
            sph_tb, field_q, lambda x: x[1][0]),
           ("closest, level 0, soup triangles (K4e)", "closest", tri_prims,
            tri_tb, soup_q, lambda x: x[0][0]),
           ("any, level 0, light 0, soup triangles (K4d)", "any", tri_prims,
            tri_tb, soup_q, lambda x: x[1][0])])
    brute_times = {}
    for label, query, prims, tb, inputs, pick in timed:
        args = [(tb, *pick(x)) for x in inputs]
        k_ms = queued_ms(lambda *a: brute_run(query, a[0], a[1:]), args)
        batch = [(query, prims, tuple(a[:PLAIN_BATCH]
                                      if torch.is_tensor(a) else a
                                      for a in x[1:])) for x in args[:3]]
        p_ms = cuda_ms(brute_plain, batch, warmup=1)
        slots = args[0][1].shape[0]
        plain_slots = batch[0][2][0].shape[0]
        plain_live = live_of(dead_of(query, batch[0][2]), plain_slots)
        print(f"brute {label}: kernel {k_ms:.4f} ms on the device "
              f"({live_of(dead_of(query, args[0][1:]), slots)} live of "
              f"{slots} slots, {tb.n_tri} triangles, {tb.n_sph} spheres), "
              f"plain {p_ms:.4f} ms on the first {plain_slots} slots "
              f"({plain_live} live) ({card})")
        brute_times[label] = (k_ms, p_ms, slots, plain_slots, plain_live,
                              brute_work(query, prims, tb, args[0][1:]))
    del field_q, soup_q
    frame_parts = {}
    for query, n in (("closest", levels), ("any", levels * n_lights)):
        rows = [v for k, v in brute_times.items()
                if k.startswith(query) and "main table" in k]
        frame_parts[query] = {"launches": n,
                              "ms": sum(v[0] for v in rows),
                              "bound_ms": sum(v[5][2] for v in rows),
                              "by_launch_ms": [v[0] for v in rows]}
        print(f"brute {query}, the frame's {n} launches: "
              f"{frame_parts[query]['ms']:.4f} ms on the device against a "
              f"bound of {frame_parts[query]['bound_ms']:.5f} ms ({card})")
    primary_bound = brute_times["closest, level 0, main table (K4b)"][5][2]
    print(f"brute closest, the primaries' bound {primary_bound:.5f} ms "
          f"(the kernel's own counters read {PRIMARY_BOUND_MS} ms)")
    if abs(primary_bound - PRIMARY_BOUND_MS) > 5e-5:
        raise AssertionError(
            f"the plain version's count of the primaries' work gives a bound "
            f"of {primary_bound:.5f} ms, not the {PRIMARY_BOUND_MS} ms that "
            f"the kernel's own stage counters gave")
    brute_ms = frame_ms(field_nb, cfg_bvh)
    print(f"frame brute sweep: {brute_ms:.4f} ms, "
          f"{mrays_per_s(field_nb, brute_ms):.2f} Mrays/s (primary+shadow), "
          f"field{FIELD_SIDE} {RES}x{RES} depth {cfg_bvh.max_depth}, {card}")
    soup_ms = frame_ms(soup_nb, cfg_bvh)
    print(f"frame brute sweep: {soup_ms:.4f} ms, soup {RES}x{RES} depth "
          f"{cfg_bvh.max_depth}, {card}")
    brute_prof = profile_frames(
        f"brute frame, sweep engine, field{FIELD_SIDE} {RES}x{RES}",
        render_tile, lambda i: (field_nb, px + 0.37 * i, py, cfg_bvh), card,
        frames=5, share_of=BRUTE_KERNEL_NAMES)
    print(f"brute-force phases {time.perf_counter() - t_brute:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    graphs.CACHE.clear()  # the graphs so far and their memory pools
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
    render_image(dscene, dcfg, torch.Generator(device=dev).manual_seed(99))
    dimg, n = replay_launches(lambda: render_image(
        dscene, dcfg, torch.Generator(device=dev).manual_seed(0)),
        (kernels.whitted_megakernel,))
    dist_launches = n["whitted_megakernel"]
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

    graphs.CACHE.clear()  # the graphs so far and their memory pools
    # 19. W1, the wavefront BVH frame: the field at 512x512, depth 4, on
    # engine="wavefront" through the walk, with the launch counters reset
    # just before and read just after, held against the sweep's image of
    # phase 10; the queue's live entries a round, frames and a profile
    t_wave = time.perf_counter()
    from dataclasses import replace

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import traverse
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_wavefront as wf,
    )

    cfg_wf = RenderConfig(engine="wavefront")
    counted = walk_kernels + brute_kernels + (kernels.whitted_megakernel,)

    def wave_frame(label, scene, cfg):
        """render_image (a graph replay, captured first) and its launches
        counted on the device (replay_launches); the queue's live entries
        a round (its counter, whitted_wavefront.live_counter), added by an
        eager frame (render_tile) and by a replay of the same frame, which
        must agree; round 0 holds the primary rays."""
        render_image(scene, cfg)
        image, counts = replay_launches(lambda: render_image(scene, cfg),
                                        counted)
        counter = wf.live_counter(px.device)
        before = counter.clone()
        render_image(scene, cfg)
        mid = counter.clone()
        render_tile(scene, px, py, cfg)
        torch.cuda.synchronize()
        by_replay = (mid - before)[1:cfg.max_depth].tolist()
        live = [px.shape[0]] + (counter - mid)[1:cfg.max_depth].tolist()
        if by_replay != live[1:]:
            raise AssertionError(f"{label}: the replay counted the queue's "
                                 f"rounds {by_replay}, the eager frame "
                                 f"{live[1:]}")
        print(f"main path: render_image {label} {RES}x{RES} depth "
              f"{cfg.max_depth} engine={cfg.engine}, launches {counts}; the "
              f"queue's live entries a round {live}")
        if image.shape != (RES, RES, 3) or not bool(
                torch.isfinite(image).all()):
            raise AssertionError(f"{label}: bad image {tuple(image.shape)}")
        if float(image.min()) < 0.0 or float(image.max()) > 1.0:
            raise AssertionError(f"{label}: image outside [0, 1]")
        return image, counts, live

    def within(label, got, want, limit=WAVE_ATOL):
        err = float((got - want).abs().max())
        print(f"{label}: max abs err {err:.3g} (limit {limit})")
        if not err <= limit:
            raise AssertionError(f"{label}: {err:.3g} is over {limit}")
        return err

    w1, w1_counts, w1_live = wave_frame(f"field{FIELD_SIDE}", field, cfg_wf)
    if w1_counts["bvh_closest"] < 1 or w1_counts["bvh_any"] < 1:
        raise AssertionError("the wavefront BVH frame did not launch the walk")
    if w1_counts["whitted_megakernel"] or w1_counts["brute_closest"] or \
            w1_counts["brute_any"]:
        raise AssertionError("the wavefront BVH frame launched another "
                             "kernel than the walk")
    w1_err = within("W1 wavefront against the sweep (phase 10)", w1, img)
    save_png(str(ROOT / "build" / "field_wavefront_smoke.png"), w1)
    w1_ms = frame_ms(field, cfg_wf)
    print(f"frame BVH wavefront: {w1_ms:.4f} ms (sweep {bvh_ms:.4f} ms), "
          f"{mrays_per_s(field, w1_ms):.2f} Mrays/s (primary+shadow), "
          f"field{FIELD_SIDE} {RES}x{RES} depth {cfg_wf.max_depth}, {card}")
    w1_prof = profile_frames(
        f"BVH frame, wavefront engine, field{FIELD_SIDE} {RES}x{RES}",
        render_tile, lambda i: (field, px + 0.37 * i, py, cfg_wf), card,
        frames=5, share_of=("closest_kernel", "any_kernel"))

    # 20. W2, the wavefront brute field frame: the same field under
    # ACCEL_NONE through the brute-force kernels, against phase 13's image
    w2, w2_counts, w2_live = wave_frame(f"field{FIELD_SIDE} accel none",
                                        field_nb, cfg_wf)
    if w2_counts["brute_closest"] < 1 or w2_counts["brute_any"] < 1:
        raise AssertionError("the wavefront brute frame did not launch the "
                             "brute-force kernels")
    if w2_counts["whitted_megakernel"] or w2_counts["bvh_closest"] or \
            w2_counts["bvh_any"]:
        raise AssertionError("the wavefront brute frame launched another "
                             "kernel than brute force")
    w2_err = within("W2 wavefront against the sweep (phase 13)", w2,
                    brute_img)
    w2_ms = frame_ms(field_nb, cfg_wf)
    print(f"frame brute wavefront: {w2_ms:.4f} ms (sweep {brute_ms:.4f} "
          f"ms), {mrays_per_s(field_nb, w2_ms):.2f} Mrays/s (primary+shadow)"
          f", field{FIELD_SIDE} {RES}x{RES} depth {cfg_wf.max_depth}, {card}")
    w2_prof = profile_frames(
        f"brute frame, wavefront engine, field{FIELD_SIDE} {RES}x{RES}",
        render_tile, lambda i: (field_nb, px + 0.37 * i, py, cfg_wf), card,
        frames=5, share_of=BRUTE_KERNEL_NAMES)

    # 21. W3, the megakernel's degrade: the field (7,398 objects, over its
    # 256) on engine="megakernel" launches no Whitted kernel and W1's walk
    # launches, with W1's image exactly; mount_low on the wavefront against
    # the Whitted kernel's image
    w3, w3_counts, _ = wave_frame(f"field{FIELD_SIDE}", field,
                                  RenderConfig(engine="megakernel"))
    if w3_counts != w1_counts:
        raise AssertionError(f"the degraded megakernel frame launched "
                             f"{w3_counts}, not W1's {w1_counts}")
    if not torch.equal(w3, w1):
        raise AssertionError("the degraded megakernel frame differs from W1")
    print("W3: engine=megakernel on the field ran the wavefront: no Whitted "
          "launch, W1's launches and W1's image bit for bit")
    mount = build_scene(scenes.mount_scene(res=RES), device=dev)
    mount_wf, _, mount_live = wave_frame("mount_low", mount, cfg_wf)
    check_pt(f"W3 mount_low {RES}x{RES} wavefront against the Whitted "
             "kernel", mount_wf, render_image(
                 mount, RenderConfig(engine="megakernel")),
             WHITTED_LIMITS["exact"])
    del mount_wf

    # 22. W4, the distribution frame on the wavefront: phase 17's plan
    # (mount_low, spp 4, soft shadows, fuzzy reflection, the u8 sky) drawn
    # once and handed to both engines
    d_sweep = render_tile(dscene, px, py, replace(dcfg, engine="sweep"),
                          draws=plan)
    d_wave = render_tile(dscene, px, py, replace(dcfg, engine="wavefront"),
                         draws=plan)
    w4_err = within(f"W4 distribution frame {RES}x{RES}, spp {dcfg.spp}, "
                    f"{dlayout.n_rows} stream rows: wavefront against the "
                    "sweep on one plan", d_wave, d_sweep)
    del d_sweep, d_wave

    # 23. W5, capacity: the BVH frame with a queue of 5% of the primaries
    cfg_cap = RenderConfig(engine="wavefront", wavefront_capacity=0.05)
    w5, _, w5_live = wave_frame(f"field{FIELD_SIDE} capacity 0.05", field,
                                cfg_cap)
    w5_mean = float((w5 - w1).abs().mean())
    primary = (render_image(field, RenderConfig(max_depth=1)) == w1).all(
        dim=-1)
    changed = float((w5 != w1).any(dim=-1).float().mean())
    print(f"W5 capacity 0.05: mean abs diff against W1 {w5_mean:.4g} (limit "
          f"0.1), {changed * 100:.3f}% of pixels changed; "
          f"{int(primary.sum())} primaries-only pixels")
    if not w5_mean < 0.1:
        raise AssertionError("W5: the capacity frame is too far from W1")
    if not torch.equal(w5[primary], w1[primary]):
        raise AssertionError("W5: a primaries-only pixel changed")
    del w5, primary
    print(f"wavefront phases {time.perf_counter() - t_wave:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    graphs.CACHE.clear()  # the graphs so far and their memory pools
    # 24-25. the per-ray traversals (csrc/perray_traverse.cu): each kernel
    # against its plain version (accel/traverse.py's *_plain) on the same
    # rays, written into poisoned outputs
    t_perray = time.perf_counter()
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import traverse

    perray_err = {f"{k} {q}": 0.0 for k in PERRAY_KINDS
                  for q in ("closest", "any")}
    for label, kind, pscene, query, args in perray_cases(dev):
        got = perray_run(kind, query, pscene, args, poison=True)
        want = perray_run(kind, query, pscene, args, kernel=False)
        torch.cuda.synchronize()
        reading = perray_agreement(query, got, want, dead_of(query, args))
        print(f"compare perray {label} ({kind} {query}): " + ", ".join(
            f"{k} {v:.3g}" for k, v in reading.items()))
        if rejects(reading, PERRAY_LIMITS):
            raise AssertionError(f"{label}: the per-ray kernel and its plain "
                                 f"version disagree beyond {PERRAY_LIMITS}")
        perray_err[f"{kind} {query}"] = max(perray_err[f"{kind} {query}"],
                                            reading["err"])
        del got, want, pscene, args
    print(f"per-ray kernels against plain {time.perf_counter() - t_perray:.1f}"
          " s")

    # 24. P1: the field under accel_impl="perray" (the median BVH's walk,
    # one compiled frame), its launches counted on the device
    cfg_pr = RenderConfig(accel_impl="perray")
    cfg_if = RenderConfig(accel_impl="perray",
                          reference_grid_shadow_initfail=True)
    bvh_pr = (kernels.perray_bvh_closest, kernels.perray_bvh_any)
    grid_pr = (kernels.grid_closest, kernels.grid_any)

    def perray_frame(label, scene, cfg, wrappers):
        """One compiled frame (the capture first): its image, launches
        counted on the device, and the first call's host wall time."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(scene, cfg)  # the capture
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        image, n, reads = replay_launch_reads(
            lambda: render_image(scene, cfg), wrappers)
        print(f"{label}: first call (warm-up and capture) {first:.3f} s "
              f"(host wall), launches a compiled frame {n} (the most of "
              f"three counted frames: {reads}), {card}")
        want = {wrappers[0].__name__: 4, wrappers[1].__name__: 8}
        if n != want:
            raise AssertionError(f"{label}: launches {n}, want {want}")
        if image.shape != (scene.camera.res_y, scene.camera.res_x, 3) or \
                not bool(torch.isfinite(image).all()):
            raise AssertionError(f"{label}: bad image {tuple(image.shape)}")
        return image, n, first

    p_res, p_field, p_walk = RES, field, img
    p1, p1_launches, p1_wall = perray_frame(
        f"P1 perray field{FIELD_SIDE} {RES}x{RES}", field, cfg_pr, bvh_pr)
    if p1_wall > PERRAY_CUT_S:
        p_res = PERRAY_CUT_RES
        print(f"P1/P2: a {RES}x{RES} frame took {p1_wall:.1f} s, over "
              f"{PERRAY_CUT_S} s: the per-ray phases run at {p_res}x{p_res}")
        p_field = build_scene(scenes.sphere_field_scene(
            n_side=FIELD_SIDE, res=p_res), device=dev)
        p_walk = render_image(p_field, cfg_bvh)
        p1, p1_launches, p1_wall = perray_frame(
            f"P1 perray field{FIELD_SIDE} {p_res}x{p_res}", p_field, cfg_pr,
            bvh_pr)
    p1_bad, _, p1_err = check_pt(f"P1 perray field{FIELD_SIDE} {p_res}x{p_res}"
                                 " against the walk", p1, p_walk,
                                 WHITTED_LIMITS["exact"])
    o0, d0 = camera_rays(p_field)
    t_w0, id_w0 = kernels.bvh_closest(p_field.packets, o0, d0)
    t_p0, id_p0 = traverse.bvh_closest_hit(p_field.bvh, p_field.prims,
                                           Rays.make(o0, d0))
    differ = id_w0 != id_p0
    tie = (t_w0 - t_p0).abs() <= 1e-6 * t_w0.abs().clamp(min=1.0)
    print(f"P1 level 0: {int(differ.sum())} of {o0.shape[0]} hit ids differ "
          f"from the walk's, {int((differ & tie).sum())} of them at equal t")
    if bool((differ & ~tie).any()):
        raise AssertionError("P1: a level-0 hit id differs from the walk's "
                             "at another t")

    # 25. P2, the grid DDA: the field under ACCEL_GRID with
    # accel_impl="perray", and with reference_grid_shadow_initfail (P2q)
    g_field = build_scene(scenes.sphere_field_scene(
        n_side=FIELD_SIDE, res=p_res, accel=C.ACCEL_GRID), device=dev)
    g = g_field.grid
    print(f"grid: {g.nx}x{g.ny}x{g.nz} cells, {g.max_per_cell} items a cell")
    p2, p2_launches, _ = perray_frame(
        f"P2 grid DDA field{FIELD_SIDE} {p_res}x{p_res}", g_field, cfg_pr,
        grid_pr)
    p2_bad, _, p2_err = check_pt(f"P2 grid DDA field{FIELD_SIDE} "
                                 f"{p_res}x{p_res} against the walk", p2,
                                 p_walk, WHITTED_LIMITS["exact"])
    p2q, p2q_launches, _ = perray_frame(
        f"P2q grid DDA with reference_grid_shadow_initfail field{FIELD_SIDE} "
        f"{p_res}x{p_res}", g_field, cfg_if, grid_pr)
    # the share of shadow rays whose grid entry failed, counted on an eager
    # frame (the plain setup reads the host; the compiled frame reads
    # nothing), which must equal the compiled one
    entry = [0, 0]
    grid_any_hit = traverse.grid_any_hit

    def counting(grid, prims, rays, max_t, dead=None,
                 init_fail_occludes=False):
        fails = traverse._grid_setup(grid, rays.origin, rays.direction)[0]
        live = ~dead if dead is not None else torch.ones_like(fails)
        entry[0] += int((fails & live).sum())
        entry[1] += int(live.sum())
        return grid_any_hit(grid, prims, rays, max_t, dead,
                            init_fail_occludes)

    p_px, p_py = pixel_grid(p_res, p_res, dev)
    traverse.grid_any_hit = counting
    try:
        p2q_eager = render_tile(g_field, p_px, p_py, cfg_if).reshape(
            p_res, p_res, 3)
    finally:
        traverse.grid_any_hit = grid_any_hit
    print(f"P2q reference_grid_shadow_initfail: {entry[0]} of {entry[1]} "
          f"shadow rays ({100 * entry[0] / max(entry[1], 1):.3f}%) failed "
          f"their grid entry and read occluded; image mean "
          f"{float(p2q.mean()):.5f} (physical {float(p2.mean()):.5f}); the "
          f"eager frame bit-equal {torch.equal(p2q_eager, p2q)}")
    if not torch.equal(p2q_eager, p2q):
        raise AssertionError("P2q: the compiled frame differs from the "
                             "eager one")

    # the kernels on the frames' own queries (frame_queries) of seven
    # drifting frames, queued as the walk's are (phase 11), each against its
    # plain version and its bound (perray_work: the kernel's own counters)
    perray_times, perray_frame_ms = {}, {}
    for kind, pscene in (("bvh", p_field), ("grid", g_field)):
        inputs = [frame_queries(pscene, *camera_rays(pscene, 0.37 * i),
                                cfg_pr) for i in range(7)]
        levels = len(inputs[0][0])
        n_l = len(inputs[0][1]) // levels
        timed = ([(f"closest, level {lvl}", "closest",
                   lambda x, lvl=lvl: (*x[0][lvl],)) for lvl in range(levels)]
                 + [(f"any, level {lvl}, light {li}", "any",
                     lambda x, k=lvl * n_l + li: (*x[1][k], False))
                    for lvl in range(levels) for li in range(n_l)])
        times = perray_times[kind] = {}
        for label, query, pick in timed:
            args = [pick(x) for x in inputs]

            def run(*a, query=query, kind=kind, pscene=pscene, **kw):
                return perray_run(kind, query, pscene, a, **kw)

            k_ms = queued_ms(run, args)
            p_ms = (cuda_ms(lambda *a: run(*a, kernel=False), args[:2],
                            warmup=1) if label.endswith("level 0")
                    or label.endswith("level 0, light 0") else None)
            print(f"perray {kind} {label}: kernel {k_ms:.4f} ms on the device"
                  + (f", plain {p_ms:.4f} ms" if p_ms is not None else "")
                  + f" ({args[0][0].shape[0]} slots, field{FIELD_SIDE} "
                  f"{p_res}x{p_res}, {card})")
            times[label] = (k_ms, p_ms, perray_work(kind, query, pscene,
                                                    args[0]))
        for query, n in (("closest", levels), ("any", levels * n_l)):
            rows = [v for k, v in times.items() if k.startswith(query)]
            times[query] = {"launches": n, "ms": sum(v[0] for v in rows),
                            "bound_ms": sum(v[2][2] for v in rows),
                            "by_launch_ms": [v[0] for v in rows]}
        print(f"perray {kind}: the frame's {levels} closest and "
              f"{levels * n_l} any-hit launches {times['closest']['ms']:.4f} "
              f"+ {times['any']['ms']:.4f} ms on the device against a bound "
              f"of {times['closest']['bound_ms'] + times['any']['bound_ms']:.5f}"
              f" ms ({card})")
        del inputs
    for label, pscene, cfg in (("P1 perray BVH", p_field, cfg_pr),
                               ("P2 grid DDA", g_field, cfg_pr),
                               ("P2q grid DDA initfail", g_field, cfg_if)):
        perray_frame_ms[label] = frame_ms(pscene, cfg)
        print(f"frame {label}: {perray_frame_ms[label]:.4f} ms compiled "
              f"(walk sweep {bvh_ms:.4f} ms at {RES}x{RES}), "
              f"field{FIELD_SIDE} {p_res}x{p_res} depth 4, {card}")
    dv_grid = dv.grid(dev)
    del p1, p2, p2q, p2q_eager
    print(f"per-ray phases {time.perf_counter() - t_perray:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    graphs.CACHE.clear()  # the graphs so far and their memory pools
    # 26. the Whitted kernel's autograd.Function against autograd straight
    # through its plain version, on CUDA tensors, case by case
    t_grad = time.perf_counter()
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    fn_readings = {}
    for label, fscene, fcfg, fdraws in function_cases(dev):
        r = fn_readings[label] = function_readings(mk.WhittedTrace.apply,
                                                   fscene, fcfg, fdraws)
        why = function_rejects(r)
        print(f"26 Function {label} {GRAD_RES}x{GRAD_RES}: forward equal to "
              f"the kernel's {r['forward_equal']}, launches (forward, "
              f"backward) {r['launches']}; gradient max abs err against "
              "plain autograd " + ", ".join(
                  f"{n} {r['err'][n]:.3g} of {r['scale'][n]:.3g}"
                  for n in GRAD_INPUTS) + f" (limit {GRAD_LIMIT[0]:g} x max "
              f"+ {GRAD_LIMIT[1]:g}); {'; '.join(why) or 'passed'}")
        if why:
            raise AssertionError(f"26 Function {label}: {'; '.join(why)}")
    fn_err = max(r["err"][n] / max(r["scale"][n], 1e-30)
                 for r in fn_readings.values() for n in GRAD_INPUTS)
    del fscene

    # 27. the main path: train_step_full on mount_low 512x512, depth 4, on
    # the megakernel engine (the Function), three steps of cli fit's light
    # recovery; then three steps of fit --fit all on the wavefront; the
    # launch counters around each step; a step timed over varied targets
    # (bench.py:263-269) and its peak memory
    m512 = build_scene(scenes.mount_scene(res=RES), device=dev)
    grad_counted = walk_kernels + brute_kernels + (kernels.whitted_megakernel,)
    sc_light = dist.lr_scales(materials=0.0, light_pos=1.0, light_color=0.0,
                              camera=0.0)
    sc_bench = dist.lr_scales(materials=1.0, light_pos=1.0, camera=1.0,
                              geometry=0.0)
    train = {}
    for engine, fit, lr in (("megakernel", "lights", LIGHT_LR),
                            ("wavefront", "all", BENCH_LR)):
        tcfg = RenderConfig(engine=engine)
        target = render_image(m512, tcfg)
        true_pos = m512.lights.position
        moved = true_pos.clone()
        moved[0] += torch.tensor([1.0, -0.7, 0.5], device=dev)
        s = replace(m512, lights=replace(m512.lights, position=moved))
        sc = sc_light if fit == "lights" else dist.lr_scales(
            materials=0.0, light_pos=1.0, light_color=0.0, camera=1.0)
        losses, offsets, step_launches = [], [], []
        for i in range(TRAIN_STEPS):
            for k in grad_counted:
                k.launches = 0
            s, loss = dist.train_step_full(s, target, tcfg, lr, None, sc)
            losses.append(float(loss))
            offsets.append(float(torch.linalg.vector_norm(
                s.lights.position - true_pos)))
            step_launches.append({k.__name__: k.launches
                                  for k in grad_counted if k.launches})
        print(f"27 train_step_full mount_low {RES}x{RES} depth 4 engine="
              f"{engine}, fit {fit}, lr {lr:g}: losses {losses}, light 0 "
              f"offsets {offsets} (from 1.3191), launches a step "
              f"{step_launches}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"27 {engine}: a loss is not finite")
        if fit == "lights" and not (falling(losses) and falling(offsets)):
            raise AssertionError(f"27 {engine}: the loss or the light's "
                                 "offset did not fall")
        want = {"whitted_megakernel": 1} if engine == "megakernel" else {}
        if any(n != want for n in step_launches):
            raise AssertionError(f"27 {engine}: launches a step "
                                 f"{step_launches}, not {want}")
        args = [(m512, target + 1e-7 * i, tcfg, BENCH_LR, None, sc_bench)
                for i in range(TIMED_STEPS)]
        step_ms = cuda_ms(dist.train_step_full, args, warmup=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base_mb = torch.cuda.memory_allocated(dev) / 2**20
        dist.train_step_full(*args[0])
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
        fwd_ms = frame_ms(m512, tcfg)
        prof = profile_frames(
            f"train step {engine}, mount_low {RES}x{RES} depth 4",
            dist.train_step_full, lambda i: args[i], card, frames=3)
        train[engine] = {"fit": fit, "lr": lr, "losses": losses,
                         "offsets": offsets, "launches": step_launches,
                         "step_ms": step_ms, "forward_frame_ms": fwd_ms,
                         "peak_mb": peak_mb, "base_mb": base_mb,
                         "profile": prof}
        print(f"27 train step {engine} (bench.py's gradient line: lr "
              f"{BENCH_LR}, materials, lights and camera, targets drifting "
              f"1e-7 a step): {step_ms:.4f} ms a step, median of "
              f"{TIMED_STEPS} (CUDA events), against a {fwd_ms:.4f} ms "
              f"forward frame; peak memory {peak_mb:.1f} MiB over "
              f"{base_mb:.1f} MiB resident; mount_low {RES}x{RES} depth 4, "
              f"{card}")
    del s, target, args

    # 28. gradients through the walk and brute force: one backward of the
    # camera, light and geometry groups on the field at 512x512, depth 4,
    # on the wavefront, with the launch counters; at 64x64 the walk's
    # gradient against brute force's
    grey = torch.full((RES, RES, 3), 0.5, device=dev)
    frozen = ("materials",)
    field_grads = {}
    for label, fscene in (("walk", field), ("brute force", field_nb)):
        for k in grad_counted:
            k.launches = 0
        floss, g = dist.value_and_grad(fscene, grey, cfg_wf, None, frozen)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in grad_counted}
        norms = {f: float(torch.linalg.vector_norm(getattr(g, f)))
                 for f in ("cam_eye", "light_pos", "prim_params")}
        finite = all(bool(torch.isfinite(x).all())
                     for x in dist.tree_leaves(g))
        field_grads[label] = {"launches": counts, "grad_norms": norms}
        print(f"28 gradient through the {label}: field{FIELD_SIDE} {RES}x"
              f"{RES} depth 4 wavefront, loss {float(floss):.6f}, gradient "
              f"norms {norms}, finite {finite}, launches {counts}")
        used = (("bvh_closest", "bvh_any") if label == "walk"
                else ("brute_closest", "brute_any"))
        if not finite or any(counts[u] < 1 for u in used):
            raise AssertionError(f"28 {label}: a gradient is not finite or "
                                 "the traversal's kernels did not launch")
    f64 = {a: build_scene(scenes.sphere_field_scene(
        n_side=FIELD_SIDE, res=GRAD_RES, accel=a), device=dev)
        for a in (C.ACCEL_BVH, C.ACCEL_NONE)}
    g64 = {a: dist.value_and_grad(f64[a], grey[:GRAD_RES, :GRAD_RES],
                                  cfg_wf, None, frozen)[1] for a in f64}
    img64 = {a: render_image(f64[a], cfg_wf) for a in f64}
    same = bool(torch.equal(img64[C.ACCEL_BVH], img64[C.ACCEL_NONE]))
    g_err = {f: float((getattr(g64[C.ACCEL_BVH], f)
                       - getattr(g64[C.ACCEL_NONE], f)).abs().max()
                      / getattr(g64[C.ACCEL_NONE], f).abs().max().clamp(
                          min=1e-30))
             for f in ("cam_eye", "light_pos", "prim_params")}
    print(f"28 at {GRAD_RES}x{GRAD_RES}: the walk's and brute force's "
          f"images equal bit for bit {same}; gradient relative max abs err "
          f"{g_err}")
    if same and not all(v <= GRAD_LIMIT[0] for v in g_err.values()):
        raise AssertionError("28: the walk's gradient differs from brute "
                             "force's where every id agrees")
    if not same and not all(v <= 5e-3 for v in g_err.values()):
        raise AssertionError("28: the walk's gradient differs from brute "
                             "force's beyond JAX's engine tolerance")
    del f64, g64, img64

    # 29. the CLI: cli fit as a subprocess on the card, the light recovery
    # at 512x512 and the geometry fit at 128x128, each printing falling
    # offsets
    cli_fit = {}
    for fit, res, lr, what in (("lights", RES, LIGHT_LR, "light offset"),
                               ("geometry", 128, GEOMETRY_LR,
                                "center offset")):
        out = subprocess.run(
            [sys.executable, "-m",
             "u_4a_2s_p3d_raytracer_template2_tpu_torch.cli", "fit",
             "--builtin", "mount", "--res", str(res), "--steps",
             str(TRAIN_STEPS), "--fit", fit, "--lr", str(lr), "--engine",
             "megakernel"], cwd=ROOT, check=True, capture_output=True,
            text=True).stdout
        print(out, end="")
        cli_fit[fit] = offsets_printed(out, what)
        if len(cli_fit[fit]) != TRAIN_STEPS or not falling(cli_fit[fit]):
            raise AssertionError(f"29 cli fit --fit {fit}: offsets "
                                 f"{cli_fit[fit]} do not fall")
    print(f"gradient phases {time.perf_counter() - t_grad:.1f} s; all "
          f"{time.perf_counter() - t_start:.1f} s")

    graphs.CACHE.clear()  # the graphs so far and their memory pools
    shard, sharded, single_ms, single_step_ms, pt_single_mean, refs = (
        sharding_phases(dev, card, mount_img, field_img))
    print(f"all {time.perf_counter() - t_start:.1f} s")

    # 34. the compiled programs (utils/graphs.py) at the headline sizes
    graph34 = graph_phase(dev, card, dscene, dcfg, field, field_nb, g_field)
    print(f"all {time.perf_counter() - t_start:.1f} s")

    # 35. NCCL across every card of the box (up to 4), one rank a card
    graphs.CACHE.clear()
    multi = multicard_phase(card, refs)
    sharded["multicard"] = None if multi is None else {
        "ranks": len(multi), "nccl": multi[0]["nccl"],
        "frame_ms_per_rank": [r["mount"]["frame_ms"] for r in multi],
        "compiled_frame_ms_per_rank": [r["mount"]["compiled_ms"]
                                       for r in multi],
        "step_ms_per_rank": [r["train"]["step_ms"] for r in multi],
        "compiled_step_ms_per_rank": [r["train"]["compiled_ms"]
                                      for r in multi]}
    print(f"all {time.perf_counter() - t_start:.1f} s")
    wave_bvh = {
        "scene": f"field{FIELD_SIDE} {RES}x{RES} depth 4, engine=wavefront",
        "launches": {"closest": w1_counts["bvh_closest"],
                     "any": w1_counts["bvh_any"]},
        "live_per_round": w1_live, "max_abs_err_vs_sweep": w1_err,
        "frame_ms": w1_ms, "sweep_frame_ms": bvh_ms, "profile": w1_prof,
        "sweep_profile": bvh_prof}
    wave_brute = {
        "scene": f"field{FIELD_SIDE} {RES}x{RES} depth 4 accel none, "
                 "engine=wavefront",
        "launches": {"closest": w2_counts["brute_closest"],
                     "any": w2_counts["brute_any"]},
        "live_per_round": w2_live, "max_abs_err_vs_sweep": w2_err,
        "frame_ms": w2_ms, "sweep_frame_ms": brute_ms, "profile": w2_prof,
        "sweep_profile": brute_prof}


    def bvh_entry(name, query, label, replaces, launches, **extra):
        k_ms, p_ms, (_, _, b_ms, b_by, live) = bvh_times[label]
        return {"name": name, "route": "cuda", "source": src + "bvh_walk.cu",
                "replaces": pk_src + replaces, **extra,
                "timed_on": label, "live": live,
                "launches": launches, "max_abs_err": bvh_err[query],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None,
                "wavefront_frame": wave_bvh,
                "gradient_frame": field_grads["walk"]}

    def brute_entry(name, query, label, replaces, **extra):
        (k_ms, p_ms, slots, plain_slots, plain_live,
         (_, _, b_ms, b_by, live)) = brute_times[label]
        return {"name": name, "route": "cuda",
                "source": src + "brute_intersect.cu",
                "replaces": pi_src + replaces,
                "entry": f"brute_{query}_launch", "timed_on": label,
                "launches": brute_launches[query == "any"],
                "max_abs_err": brute_err[query], "ms": k_ms,
                "slots": slots, "live": live, "plain_ms": p_ms,
                "plain_slots": plain_slots, "plain_live": plain_live,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "wavefront_frame": wave_brute,
                "gradient_frame": field_grads["brute force"], **extra}

    def perray_entry(name, kind, query, replaces, launches):
        label = ("closest, level 0" if query == "closest"
                 else "any, level 0, light 0")
        k_ms, p_ms, (_, _, b_ms, b_by, live) = perray_times[kind][label]
        frames = {k: v for k, v in perray_frame_ms.items()
                  if k.startswith("P1" if kind == "bvh" else "P2")}
        return {"name": name, "route": "cuda",
                "source": src + "perray_traverse.cu",
                "replaces": tr_src + replaces,
                "entry": ("median_bvh" if kind == "bvh" else "grid")
                + f"_{query}_launch",
                "timed_on": label, "live": live, "launches": launches,
                "max_abs_err": perray_err[f"{kind} {query}"], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "frame": perray_times[kind][query],
                "compiled_frame_ms": frames,
                "scene": f"field{FIELD_SIDE} {p_res}x{p_res} depth 4"}

    src = "u_4a_2s_p3d_raytracer_template2_tpu_torch/csrc/"
    pk_src = "u_4a_2s_p3d_raytracer_template2_tpu/accel/packets.py"
    tr_src = "u_4a_2s_p3d_raytracer_template2_tpu/accel/traverse.py"
    pi_src = "u_4a_2s_p3d_raytracer_template2_tpu/ops/pallas_intersect.py"
    print(f"replays' profiler reads short of the graphs' kernel nodes (this "
          f"process): {len(LOST_READS)} {LOST_READS}")
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
        "function": {
            "cases": {label: {"err": r["err"], "scale": r["scale"],
                              "launches": r["launches"]}
                      for label, r in fn_readings.items()},
            "max_rel_err": fn_err, "limit": GRAD_LIMIT},
        "train_step": train,
        "sharded": dict(
            sharded, scene=f"mount_low {RES}x{RES} depth 4",
            launches_per_rank=[r["mount"]["launches"] for r in shard],
            step_launches_per_rank=[r["train"]["launches"] for r in shard],
            replay_launches_per_rank=[r["mount"]["replay_launches"]
                                      for r in shard],
            step_replay_launches_per_rank=[
                r["train"]["compiled"]["replay_launches"] for r in shard],
            frame_ms_per_rank=[r["mount"]["frame_ms"] for r in shard],
            compiled_frame_ms_per_rank=[r["mount"]["compiled_ms"]
                                        for r in shard],
            single_frame_ms=single_ms,
            step_ms_per_rank=[r["train"]["step_ms"] for r in shard],
            compiled_step_ms_per_rank=[r["train"]["compiled_ms"]
                                       for r in shard],
            single_step_ms=single_step_ms),
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
        "sharded": dict(
            sharded, launches_per_rank=[r["pt"]["launches"] for r in shard],
            replay_launches_per_rank=[r["pt"]["replay_launches"]
                                      for r in shard],
            frame_ms_per_rank=[r["pt"]["frame_ms"] for r in shard],
            compiled_frame_ms_per_rank=[r["pt"]["compiled_ms"]
                                        for r in shard],
            agreement_per_rank=[r["pt"]["agreement"] for r in shard],
            frame_mean=shard[0]["pt"]["mean"],
            single_frame_mean=pt_single_mean),
    },
        bvh_entry("bvh_walk closest", "closest", "closest, level 0", ":770",
                  bvh_launches[0], also_replaces=pk_src + ":843",
                  frame=walk_frame["closest"],
                  sharded_launches_per_rank=[
                      r["field"]["launches"]["bvh_closest"] for r in shard],
                  sharded_replay_launches_per_rank=[
                      r["field"]["replay_launches"]["bvh_closest"]
                      for r in shard]),
        bvh_entry("bvh_walk any", "any", "any, level 0, light 0",
                  ":813", bvh_launches[1], frame=walk_frame["any"],
                  sharded_launches_per_rank=[
                      r["field"]["launches"]["bvh_any"] for r in shard],
                  sharded_replay_launches_per_rank=[
                      r["field"]["replay_launches"]["bvh_any"]
                      for r in shard]),
        bvh_entry("bvh_walk any multi", "multi",
                  "multi, level 0, both lights", ":729", multi_launches),
        brute_entry("brute_intersect closest, spheres (K4a)", "closest",
                    "closest, level 0, field spheres (K4a)", ":186"),
        brute_entry("brute_intersect closest, triangles and spheres (K4b)",
                    "closest", "closest, level 0, main table (K4b)", ":377",
                    frame=frame_parts["closest"]),
        brute_entry("brute_intersect any, spheres (K4c)", "any",
                    "any, level 0, light 0, field spheres (K4c)", ":525",
                    frame=frame_parts["any"]),
        brute_entry("brute_intersect any, triangles (K4d)", "any",
                    "any, level 0, light 0, soup triangles (K4d)", ":553"),
        brute_entry("brute_intersect closest, triangles (K4e)", "closest",
                    "closest, level 0, soup triangles (K4e)", ":590"),
        perray_entry("perray_bvh closest", "bvh", "closest", ":70",
                     p1_launches["perray_bvh_closest"]),
        perray_entry("perray_bvh any", "bvh", "any", ":70",
                     p1_launches["perray_bvh_any"]),
        perray_entry("grid_dda closest", "grid", "closest", ":206",
                     p2_launches["grid_closest"]),
        perray_entry("grid_dda any", "grid", "any", ":287",
                     p2_launches["grid_any"]),
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
