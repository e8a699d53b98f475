"""Planted faults in the port's kernels, held to chip_smoke.py's limits.

    python3 chip_faults.py       # from the root of a checkout; needs one card

Builds copies of csrc/whitted_megakernel.cu, csrc/pt_megakernel.cu,
csrc/bvh_walk.cu, csrc/brute_intersect.cu, csrc/probes.cu and
csrc/perray_traverse.cu (with the headers they include) with one fault
planted in each (under build/copies/,
kernels/build.build_copy, one nvcc per copy, all started together), two
controls of the Whitted kernel (WHITTED_CONTROLS) and the design controls
of both megakernels (WHITTED_DESIGN, PT_DESIGN), and runs the sound kernels
and every faulty one through chip_smoke.py's cases against the plain
versions on the same inputs:
  * the Whitted kernel's (chip_smoke.whitted_cases), printing the share of
    pixels beyond 2e-3 and the mean and max abs difference of each, and
    whether the case's limits (chip_smoke.WHITTED_LIMITS) reject it;
  * the Whitted kernel's 512x512 distribution frame (chip_smoke.py's phase
    17 comparison), with the same readings for the sound kernel, each
    fault and each control, judged by WHITTED_LIMITS["frame"]: the sound
    kernel must pass it and the build with contraction must be rejected;
    then the sound kernel's readings with fuzzy reflection off, with the
    sky off, with both off, and at depths 1 and 2, which locate what it
    reads with all on, and the kernel's time a subpixel launch built with
    and without contraction, in turns;
  * the path tracer's (chip_smoke.pt_cases), printing the share of pixels
    beyond 2e-3 and the mean and max abs difference of each, and whether
    the case's limits (chip_smoke.PT_LIMITS) reject it;
  * the BVH walk's (chip_smoke.bvh_cases), printing over the live slots
    the share of rays whose closest-hit ids differ, the largest relative t
    difference and the share of occlusion results that differ, and the
    share of dead slots whose answer is wrong (chip_smoke.live_agreement,
    the kernel writing into poisoned outputs), and whether
    chip_smoke.BVH_LIMITS reject it; then the walk's design controls
    (BVH_DESIGN: the binary tree, every slot traced or queued, each leaf
    row read when it is tested), which must answer as the sound walk does
    on every slot of the BVH frame's 12 launches, each timed beside it in
    turns (tools/megakernels.walk_timed_in_turns);
  * the per-ray traversals' (chip_smoke.perray_cases: the median BVH's
    walk and the grid DDA, closest and any hit) with the same readings,
    the share of live slots whose ids differ at another t, and the dead
    slots', judged by chip_smoke.PERRAY_LIMITS (PERRAY_FAULTS: the inside
    box's entry of 0 dropped, a leaf's tie taking the last object, the
    DDA's exit-axis tie taken z first, a dead slot traced, the initfail
    quirk ignored, a node record's child boxes read swapped, the walk's
    stack cut to 16 entries, which the deep tree's rays overflow); only
    this check runs with
    ``python3 -c "import chip_faults, torch;
    chip_faults.perray_only(torch.device('cuda', 0))"``;
  * the brute-force kernels' (chip_smoke.brute_cases) with the same
    readings over the live slots and the share of dead slots whose answer
    is wrong (chip_smoke.live_agreement, the kernel writing into poisoned
    outputs), judged by chip_smoke.BRUTE_LIMITS; then the brute-force
    controls (BRUTE_CONTROLS: the designs the sound kernel was chosen
    over), which must answer as the sound kernel does, each timed beside
    it in turns on the field's frame queries and the soup's triangles;
  * the device probes' checks of chip_smoke.py's phase 15: T3's walks of
    tools/probe_features.walk_cases against the oracle, exactly, in both
    stack placements, and T1's cheap class against its plain version
    (tools/roofline_mount.RTOL) and under 1.05 x its class ceiling;
  * the Whitted kernel's autograd.Function (phase 26 of chip_smoke.py):
    the sound WhittedTrace must pass chip_smoke.function_cases under
    chip_smoke.GRAD_LIMIT, and a backward planted to drop o's and d's
    gradient must be rejected in every case (function_verdicts);
  * the sharded paths (phases 30-32 and 35 of chip_smoke.py,
    shard_verdicts): two gloo ranks rendering mount_low, taking one
    light-recovery step and tracing glsl_world, each eager and compiled,
    must pass chip_smoke.sharded_rejects when sound and be rejected with
    rank 1 writing its slice one pixel early, with the gradient all-reduce
    skipped, with the rank generator seeded once at capture, with rank
    1's slice placed one row early in the all-gather and with the last
    rank tracing its path-tracer slice one row early
    (chip_smoke.SHARD_FAULTS); on two or more cards so must NCCL ranks,
    one a card, under the last four; only this check runs with
    ``python3 -c "import chip_faults, torch;
    chip_faults.shard_verdicts(torch.device('cuda', 0))"``;
  * the compiled programs (phase 34 of chip_smoke.py, graph_verdicts):
    chip_smoke.graph_checks at 128x128 must pass the sound programs and
    reject each of chip_smoke.GRAPH_FAULTS (the graph's generator not
    registered; every replay restarting from the capture's draws; the
    camera not copied in; the megakernel tables packed into the caller's
    Scene.cache by the capture, with no warm-up; the train step's graph
    returning the scene it was given, its update lost); only this check
    runs with
    ``python3 -c "import chip_faults, torch;
    chip_faults.graph_verdicts(torch.device('cuda', 0))"``;
  * the train step's gathers (gather_control): the control reads the
    primitives' and materials' rows by indexing, whose CUDA backward adds
    each row's duplicates in one serial loop, in place of index_select;
    it must compute the sound step's loss and update, and both are timed
    in turns on mount_low 512x512, depth 4, on both engines;
  * the megakernels' design controls, each of which puts back one element
    of the kernel's design before its redesign for the card (the rows
    without pads, one primitive a step, the refraction stack in registers,
    the launch bounds, the centre's lerp for static spheres): each must
    answer as the sound kernel does, bit for bit, on the main paths'
    launches (tools/megakernels.main_inputs), and is timed beside it in
    turns.
Exits non-zero if a limit rejects a sound kernel, no case rejects a faulty
one, or a design control answers otherwise than the sound kernel.
"""
import concurrent.futures
import ctypes
import dataclasses
import tempfile
import subprocess
import sys

import torch

import chip_smoke

# (name, text of csrc/whitted_megakernel.cu, its faulty replacement)
WHITTED_FAULTS = (
    ("refl/refr path index swapped",
     """        const int refl_path = branch == 2 ? 2 * path : path;
        const int refr_path = branch == 2 ? 2 * path + 1 : path;""",
     """        const int refl_path = branch == 2 ? 2 * path + 1 : path;
        const int refr_path = branch == 2 ? 2 * path : path;"""),
    ("shadow jitter without the subpixel offset",
     "const float jx = 0.5f * ((jit.si + ux) / (float)jit.spp);",
     "const float jx = 0.5f * (ux / (float)jit.spp);"),
    ("fuzzy hemisphere test dropped",
     "if (dot(fz, nf) > 0.f) rd = fz;", "rd = fz;"),
    ("LEFT/RIGHT faces swapped",
     "int side = use_x ? (d.x >= 0.f ? 1 : 0)",
     "int side = use_x ? (d.x >= 0.f ? 0 : 1)"),
    ("u8 divided by 255",
     "constexpr float kU8Scale = 255.99f;", "constexpr float kU8Scale = 255.f;"),
    ("jittered y offset read from the x row",
     "const float uy = __ldg(jit.u + (size_t)(2 * li + 1) * jit.n_rays);",
     "const float uy = __ldg(jit.u + (size_t)(2 * li) * jit.n_rays);"),
)


# Builds of csrc/whitted_megakernel.cu read on the distribution frame beside
# the faults: (name, (text, its replacement) pairs, nvcc flags left out, and
# the frame limit's verdict required: True to reject, None for the reading
# alone). Contracted, the kernel's sky directions round otherwise than the
# plain version's, and the frame limit must see it; kernels/build.py builds
# the kernel without contraction for that reason. The second takes the
# plain version's cube root, pow(u, 1/3), in place of cbrtf: it reads as
# the sound kernel does, so the frame's differences do not come from the
# fuzzy transform's libm calls (PERF.md).
WHITTED_CONTROLS = (
    ("built with contraction", (), ("--fmad=false",), True),
    ("unit-sphere radius as powf(u, 1/3)",
     (("const float r = cbrtf(u3);", "const float r = powf(u3, 1.f / 3.f);"),),
     (), None),
)


# The megakernels' design controls: builds of csrc/whitted_megakernel.cu
# and csrc/pt_megakernel.cu that each put back one element of the design
# the kernel had before it was redesigned for the card, or
# take the alternative the element was chosen over (four rows a step), as
# (name, (text, its replacement) pairs). Each must answer as the sound
# kernel does, bit for bit, on the main paths' launches
# (tools/megakernels.main_inputs), and is timed beside it in turns (sound,
# control, control, sound); an element stays only where its control is
# slower.
_SCALAR_ROWS = ("  return reinterpret_cast<const float4*>(row)[k];",
                "  return make_float4(row[4 * k], row[4 * k + 1], "
                "row[4 * k + 2], row[4 * k + 3]);")
_REGISTER_STACK = (
    """  __device__ __forceinline__ void push(const Entry& x) { e[size++] = x; }
  __device__ __forceinline__ Entry pop() { return e[--size]; }""",
    """  __device__ __forceinline__ void push(const Entry& x) {
#pragma unroll
    for (int k = CAP - 1; k > 0; --k) e[k] = e[k - 1];
    e[0] = x;
    ++size;
  }
  __device__ __forceinline__ Entry pop() {
    const Entry x = e[0];
#pragma unroll
    for (int k = 0; k < CAP - 1; ++k) e[k] = e[k + 1];
    --size;
    return x;
  }""")
WHITTED_DESIGN = (
    ("23-float rows read a float at a time",
     (("constexpr int kTblW = 24;", "constexpr int kTblW = 23;"),
      _SCALAR_ROWS)),
    ("one primitive a step",
     (("constexpr int kGroup = 2;", "constexpr int kGroup = 1;"),)),
    ("four primitives a step",
     (("constexpr int kGroup = 2;", "constexpr int kGroup = 4;"),)),
    ("the refraction stack in registers (a shift register)",
     (_REGISTER_STACK,)),
    ("launch bounds (128, 4)",
     (("constexpr int kMinBlocks = 5;", "constexpr int kMinBlocks = 4;"),)),
)
PT_DESIGN = (
    ("21-float rows read a float at a time",
     (("constexpr int kRowW = 24;", "constexpr int kRowW = 21;"),
      ("constexpr int kGeomW = 12;", "constexpr int kGeomW = 9;"),
      _SCALAR_ROWS)),
    ("one sphere a step",
     (("constexpr int kGroup = 4;", "constexpr int kGroup = 1;"),)),
    ("the centre lerped for every sphere",
     (("""  if (span == 0.f) return c0;
  const float frac = (time - p1.w) / span;""",
       """  const float frac = span == 0.f ? 0.f : (time - p1.w) / span;"""),)),
)


# (name, text of csrc/pt_megakernel.cu, its faulty replacement)
PT_FAULTS = (
    ("no dielectric highlight",
     "mtype == kMetal ? albedo : v3(0.004f, 0.004f, 0.004f)",
     "mtype == kMetal ? albedo : v3(0.f, 0.f, 0.f)"),
    ("hollow shell not flipped",
     "* (p[6] < 0.f ? -1.f : 1.f)", "* 1.f"),
    ("no Beer's law",
     "atten = albedo * v3(expf(rc.x * -t), expf(rc.y * -t), "
     "expf(rc.z * -t));",
     "atten = albedo;"),
    ("metal fuzz renormalised",
     "new_d = mirror + rough * unit_sphere(u[3 * R], u[4 * R], u[5 * R]);",
     "new_d = normalize(mirror + rough * unit_sphere(u[3 * R], u[4 * R], "
     "u[5 * R]));"),
    ("triangle u+v guard",
     "if (!(v >= 0.f && v <= 1.f)) return kBig;",
     "if (!(v >= 0.f && u + v <= 1.f)) return kBig;"),
    ("feeler bound ignores len1",
     "shadow_len1 ? 1.f : len", "len"),
)


# (name, text of csrc/bvh_walk.cu, its faulty replacement)
BVH_FAULTS = (
    ("slab test without the safe inverse",
     "r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);",
     "r.ix = 1.f / r.dx; r.iy = 1.f / r.dy; r.iz = 1.f / r.dz;"),
    ("leaf loop skips its last primitive",
     "if (k < m.y) {  // row m.x + k of the leaf",
     "if (k < m.y - 1) {  // row m.x + k of the leaf"),
    ("any hit ignores max_t",
     "if (t < max_t) return true;  // an occluder",
     "if (t < kBig) return true;  // an occluder"),
    ("a dead slot's answer left unwritten",
     "        out_t[slot] = kBig;\n        out_id[slot] = -1;\n", ""),
    ("the pack drops the last live ray of a block",
     "if (threadIdx.x < queued) {", "if (threadIdx.x + 1 < queued) {"),
    ("a wide visit skips its fourth child",
     "const bool hit = count >= 0 && tn <= tf",
     "const bool hit = c < 3 && count >= 0 && tn <= tf"),
)


# Builds of csrc/bvh_walk.cu timed beside the sound walk on the BVH frame's
# 12 launches (tools/megakernels.walk_inputs): each puts back one element
# of the walk's design before its redesign for the card (the binary tree;
# every slot traced; every slot queued, the dead ones idle in their warps,
# as the any hit ran; each leaf row read when it is tested), as (name,
# (text, its replacement) pairs). Each must answer as the sound walk does,
# bit for bit, and an element stays only where its control is slower. A
# control whose kWidth differs reads the tree collapsed to that width
# (tools/megakernels.walk_tables).
_EVERY_SLOT = ("const bool live = in && !(dead && dead[mine]);",
               "const bool live = in;")
BVH_DESIGN = (
    ("the binary tree (2-wide nodes, the 64-B child pair of PRs 3-8)",
     (("constexpr int kWidth = 4;", "constexpr int kWidth = 2;"),)),
    ("every slot traced, dead answers written after the walk",
     (_EVERY_SLOT,
      ("    on_live(slot);\n",
       "    on_live(slot);\n    if (dead && dead[slot]) on_dead(slot);\n"))),
    ("every slot queued, dead slots idle in their warps",
     (_EVERY_SLOT,
      ("    on_live(slot);\n",
       "    if (dead && dead[slot])\n      on_dead(slot);\n"
       "    else\n      on_live(slot);\n"))),
    ("each leaf row read when it is tested",
     (("""      float4 head[kLeafRows], p0[kLeafRows];
      read_leaf(T.rows, m, head, p0);
#pragma unroll
      for (int k = 0; k < kLeafRows; ++k) {
        if (k < m.y) {  // row m.x + k of the leaf
          float t = row_t<COUNT>(T.rows, m.x + k, head[k], p0[k], r, rank,
                                 id, w);
          offer(t, rank, id);
        }
      }""", """      for (int i = m.x; i < m.x + m.y; ++i) {
        float t = row_t<COUNT>(T.rows, i, __ldg(T.rows + 4 * i + 3),
                               __ldg(T.rows + 4 * i), r, rank, id, w);
        offer(t, rank, id);
      }"""),
      ("""      float4 head[kLeafRows], p0[kLeafRows];
      read_leaf(T.rows, m, head, p0);
#pragma unroll
      for (int k = 0; k < kLeafRows; ++k) {
        if (k < m.y) {
          const float t = row_t<COUNT>(T.rows, m.x + k, head[k], p0[k], r,
                                       rank, id, w);
          if (t < max_t) return true;  // an occluder
        }
      }""", """      for (int i = m.x; i < m.x + m.y; ++i)
        if (row_t<COUNT>(T.rows, i, __ldg(T.rows + 4 * i + 3),
                         __ldg(T.rows + 4 * i), r, rank, id, w) < max_t)
          return true;"""))),
)


# (name, text of csrc/brute_intersect.cu or of the tests it shares with the
# walk, csrc/prim_tests.cuh, and its faulty replacement)
BRUTE_FAULTS = (
    ("tie rule keeps the higher id",
     "(r == rank && i < id)", "(r == rank && i > id)"),
    ("tile loop drops the last partial tile",
     "base < sph_hi; base += kSphTile", "base + kSphTile <= sph_hi; "
     "base += kSphTile"),
    ("slices drop the rows past the last whole slice",
     "const int per = (n_rows + slices - 1) / slices;  // rows a slice",
     "const int per = n_rows / slices;  // rows a slice"),
    ("any hit ignores max_t",
     "return t < max_t;", "return t < kBig;"),
    ("sphere test always takes the larger root",
     "float t = lo < 0.f ? hi : lo;", "float t = hi;"),
    ("the sweep drops the last partial group of live rays",
     "const int groups = (n + kGroup - 1) / kGroup;",
     "const int groups = n / kGroup;"),
    ("the slice combine drops the type rank from the key",
     "return ((unsigned long long)tb << 32) | ((unsigned)b.rank << 31) |\n"
     "         (unsigned)b.id;",
     "return ((unsigned long long)tb << 32) | (unsigned)b.id;"),
    ("the any-hit vote reads one lane",
     "return __any_sync(kAll, hit);", "return __shfl_sync(kAll, hit, 0);"),
    ("a dead slot's output is left unwritten",
     "    out.t[slot] = kBig;  // a dead slot: no hit\n"
     "    out.id[slot] = -1;\n", ""),
)


# (name, text of csrc/perray_traverse.cu or of a header it includes, its
# faulty replacement)
PERRAY_FAULTS = (
    ("the inside-box 0 dropped",
     "      if (lin) ldist = 0.f;\n      if (rin) rdist = 0.f;\n", ""),
    ("a leaf tie taking the last object",
     "          if (t < lt) {", "          if (t <= lt) {"),
    ("the DDA's axis tie taken z-first",
     "  if (s.tz < t_exit) {", "  if (s.tz <= t_exit) {"),
    ("a dead slot traced",
     "const bool live = in && !(dead && dead[mine]);",
     "const bool live = in;"),
    ("init_fail_occludes ignored",
     "        if (init_fail_occludes && misses) occ = true;  "
     "// grid.cpp:326-328\n", ""),
    ("a node record's child boxes swapped",
     "r, lhit,\n                ldist, lin);\n"
     "      box_enter(q[1].z, q[1].w, q[2].x, q[2].y, q[2].z, q[2].w, r, rhit,\n"
     "                rdist, rin);",
     "r, rhit,\n                rdist, rin);\n"
     "      box_enter(q[1].z, q[1].w, q[2].x, q[2].y, q[2].z, q[2].w, r, lhit,\n"
     "                ldist, lin);"),
    ("the walk's stack cut to 16 entries",
     "constexpr int kStack = 64;", "constexpr int kStack = 16;"),
)


# Builds of csrc/brute_intersect.cu timed beside the sound kernel on the
# field's frame queries and the soup's triangles (brute_controls): the
# designs the sound kernel was chosen over. Each is (name, (text, its
# replacement) pairs); each must answer as the sound kernel does, bit for
# bit.
BRUTE_CONTROLS = (
    ("sphere rows with one branch a ray",
     (("""        Gate gate[kRays];
        bool open = false;
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          gate[k] = sphere_gate(p, rr, ray[k]);
          open |= gate[k].open();
        }
        if (open) {
          const int id = __ldg(T.sph_id + base + j);
#pragma unroll
          for (int k = 0; k < kRays; ++k)
            if (gate[k].open()) best[k].offer(gate[k].t(ray[k]), 1, id);
        }""", """#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          const Gate g = sphere_gate(p, rr, ray[k]);
          if (g.open())
            best[k].offer(g.t(ray[k]), 1, __ldg(T.sph_id + base + j));
        }"""),)),
    ("triangle rows with one branch a ray (triangle_t)",
     (("""        TriGate gate[kRays];
        bool open = false;
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          gate[k] = triangle_gate(p0, p1, p2, ray[k]);
          open |= gate[k].open();
        }
        if (open) {
#pragma unroll
          for (int k = 0; k < kRays; ++k)
            if (gate[k].open())
              best[k].offer(gate[k].t(p0, p1, p2, ray[k]), 0,
                            __float_as_int(p2.y));
        }""", """#pragma unroll
        for (int k = 0; k < kRays; ++k)
          best[k].offer(triangle_t(p0, p1, p2, ray[k]), 0,
                        __float_as_int(p2.y));"""),
      ("""          const TriGate g = triangle_gate(p0, p1, p2, r);
          hit = g.open() && blocks(g.t(p0, p1, p2, r), max_t);""",
       """          hit = blocks(triangle_t(p0, p1, p2, r), max_t);"""))),
    ("any hit with the whole table resident in shared memory, 1,024 threads "
     "a block (fits the field and the soup only)",
     (("constexpr int kAnyThreads = 256; ", "constexpr int kAnyThreads = 1024; "),
      ("""  const int lane = threadIdx.x & 31;
  for (int w = blockIdx.x * kAnyWarps""", """  const int lane = threadIdx.x & 31;
  extern __shared__ float4 s_tab[];
  for (int i = threadIdx.x; i < 3 * T.n_tri + T.n_sph; i += kAnyThreads)
    s_tab[i] = i < 3 * T.n_tri ? __ldg(T.tri + i)
                               : __ldg(T.sph + i - 3 * T.n_tri);
  __syncthreads();
  for (int w = blockIdx.x * kAnyWarps"""),
      ("""          const float4* p = T.tri + 3 * j;
          const float4 p0 = __ldg(p), p1 = __ldg(p + 1), p2 = __ldg(p + 2);""",
       """          const float4* p = s_tab + 3 * j;
          const float4 p0 = p[0], p1 = p[1], p2 = p[2];"""),
      ("const float4 p = __ldg(T.sph + j - T.n_tri);",
       "const float4 p = s_tab[2 * T.n_tri + j];"),
      ("""  const int grid = persistent_grid((const void*)brute_any_sweep, kAnyThreads,
                                   1, true);
  brute_any_sweep<<<grid, kAnyThreads, 0, st>>>""",
       """  const int smem = 16 * (3 * n_tri + n_sph);
  cudaFuncSetAttribute((const void*)brute_any_sweep,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, grid = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&grid, cudaDevAttrMultiProcessorCount, dev);
  brute_any_sweep<<<grid, kAnyThreads, smem, st>>>"""))),
)


# (name, text of csrc/probes.cu, its faulty replacement)
PROBE_FAULTS = (
    ("T3 stack keeps one entry",
     "return sp;  // one slot per entry", "return 0;  // one slot per entry"),
    ("T1 cheap chain idempotent",
     "if (OP == kCheap) return fabsf(acc - x);",
     "if (OP == kCheap) return fmaxf(acc, x);"),
)


def entry_of(lib, name, like):
    """``name`` of the library ``lib`` with the C types of ``like``."""
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.restype, fn.argtypes = like.restype, like.argtypes
    return fn


def whitted_verdicts(dev, kernels, sound, faulty):
    """Names of the Whitted kernels the limits judge wrongly."""
    cases = list(chip_smoke.whitted_cases(dev))
    wants = [chip_smoke.whitted_run(scene, cfg, draws, kernel=False)
             for _, _, scene, cfg, draws in cases]
    failed = []
    for name, lib in [("sound", None)] + faulty:
        entry = sound if lib is None else entry_of(
            lib, "whitted_megakernel_launch", sound)
        kernels._whitted_entry = lambda entry=entry: entry
        rejected = 0
        for (label, (max_bad, max_mean), scene, cfg, draws), want in zip(
                cases, wants):
            got = chip_smoke.whitted_run(scene, cfg, draws)
            bad, mean, err = chip_smoke.pt_agreement(got, want)
            out = (bad > max_bad or mean > max_mean
                   or not bool(torch.isfinite(got).all()))
            rejected += out
            print(f"{name} | {label}: {bad * 100:.4f}% pixels beyond "
                  f"{chip_smoke.ATOL}, mean abs diff {mean:.3g}, max abs diff "
                  f"{err:.3g}; limits {max_bad * 100}%, {max_mean}: "
                  f"{'rejected' if out else 'passed'}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    return failed


def frame_verdicts(dev, kernels, sound, faulty, controls):
    """Names of the Whitted builds the distribution frame's limit judges
    wrongly: the sound kernel must pass and each control whose verdict is
    set must get it; the faults' readings are printed. Then the sound
    kernel's readings on the frame with fuzzy reflection off, the sky off,
    both, and at depths 1 and 2 (each must pass), and the kernel's time
    built with and without contraction (WHITTED_CONTROLS[0])."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import samples
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_megakernel as mk,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
        subpixel_rays,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        device_validate as dv,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.timing import (
        queued_ms,
    )

    res = chip_smoke.RES
    max_bad, max_mean = chip_smoke.WHITTED_LIMITS["frame"]
    with tempfile.TemporaryDirectory() as env:
        scene, cfg = dv.distribution_scene(dev, env_dir=env, res=res,
                                           sky_side=chip_smoke.DIST_SKY)

    def plan_of(cfg):
        return samples.draw_plan(torch.Generator(device=dev).manual_seed(1),
                                 samples.scene_layout(scene, cfg), cfg,
                                 res * res)

    def rejects(name, cfg, plan, want):
        got = chip_smoke.whitted_run(scene, cfg, plan)
        bad, mean, err = chip_smoke.pt_agreement(got, want)
        out = (bad > max_bad or mean > max_mean
               or not bool(torch.isfinite(got).all()))
        print(f"{name} | distribution frame {res}x{res}: {bad * 100:.4f}% "
              f"pixels beyond {chip_smoke.ATOL}, mean abs diff {mean:.3g}, "
              f"max abs diff {err:.3g}; limits {max_bad * 100}%, "
              f"{max_mean}: {'rejected' if out else 'passed'}")
        return out

    plan = plan_of(cfg)
    want = chip_smoke.whitted_run(scene, cfg, plan, kernel=False)
    entries = {}
    failed = []
    for name, lib, verdict in ([("sound", None, False)]
                               + [(n, lib, None) for n, lib in faulty]
                               + controls):
        entries[name] = sound if lib is None else entry_of(
            lib, "whitted_megakernel_launch", sound)
        kernels._whitted_entry = lambda entry=entries[name]: entry
        if rejects(name, cfg, plan, want) != verdict and verdict is not None:
            failed.append(name)
    kernels._whitted_entry = lambda: sound
    for label, kw in (("fuzzy reflection off", dict(fuzzy_reflection=False)),
                      ("sky off", dict(use_skybox=False)),
                      ("fuzzy reflection and sky off",
                       dict(fuzzy_reflection=False, use_skybox=False)),
                      ("depth 1 (misses of primary rays only)",
                       dict(max_depth=1)),
                      ("depth 2", dict(max_depth=2))):
        acfg = dataclasses.replace(cfg, **kw)
        aplan = plan_of(acfg)
        if rejects(f"sound, {label}", acfg, aplan, chip_smoke.whitted_run(
                scene, acfg, aplan, kernel=False)):
            failed.append(f"sound, {label}")
    px, py = pixel_grid(res, res, dev)
    tbl, lt, bg = mk.scene_tables(scene)
    shape, sky = mk.shape_of(scene), mk.sky_of(scene, cfg)
    args = []
    for s in plan:
        r = subpixel_rays(scene, px, py, cfg, s)
        args.append((tbl, lt, bg, r.origin.contiguous(),
                     r.direction.contiguous(), shape, cfg, s.rows, sky, s.ij))
    contracted = controls[0][0]
    for _ in range(3):
        for name in (contracted, "sound", "sound", contracted):
            kernels._whitted_entry = lambda entry=entries[name]: entry
            ms = queued_ms(kernels.whitted_megakernel, args)
            print(f"time {name}: {ms:.4f} ms a subpixel launch of the "
                  "distribution frame", flush=True)
    kernels._whitted_entry = lambda: sound
    return failed


def pt_verdicts(dev, kernels, sound, faulty):
    """Names of the path-tracer kernels the limits judge wrongly."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pt_megakernel as ptk,
    )

    cases = list(chip_smoke.pt_cases(dev))
    wants = [ptk.trace_rays_plain(tables, *args, cfg)
             for _, _, tables, args, cfg in cases]
    failed = []
    for name, lib in [("sound", None)] + faulty:
        entry = sound if lib is None else entry_of(
            lib, "pt_megakernel_launch", sound)
        kernels._pt_entry = lambda entry=entry: entry
        rejected = 0
        for (label, (max_bad, max_mean), tables, args, cfg), want in zip(
                cases, wants):
            got = kernels.pt_megakernel(tables, *args, cfg)
            bad, mean, err = chip_smoke.pt_agreement(got, want)
            out = (bad > max_bad or mean > max_mean
                   or not bool(torch.isfinite(got).all()))
            rejected += out
            print(f"{name} | {label}: {bad * 100:.4f}% pixels beyond "
                  f"{chip_smoke.ATOL}, mean abs diff {mean:.3g}, max abs diff "
                  f"{err:.3g}; limits {max_bad * 100}%, {max_mean}: "
                  f"{'rejected' if out else 'passed'}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    return failed


def bvh_verdicts(dev, kernels, sound, faulty):
    """Names of the BVH walk's kernels the limits judge wrongly."""
    cases = list(chip_smoke.bvh_cases(dev))
    wants = [chip_smoke.bvh_run(query, tables, args, kernel=False)
             for _, tables, query, args in cases]
    failed = []
    for name, lib in [("sound", None)] + faulty:
        entries = {n: sound[n] if lib is None else entry_of(lib, n, sound[n])
                   for n in sound}
        kernels._bvh_entry = lambda n, entries=entries: entries[n]
        rejected = 0
        for (label, tables, query, args), want in zip(cases, wants):
            reading = chip_smoke.live_agreement(
                query, chip_smoke.bvh_run(query, tables, args, poison=True),
                want, chip_smoke.dead_of(query, args))
            out = chip_smoke.rejects(reading, chip_smoke.BVH_LIMITS)
            rejected += bool(out)
            print(f"{name} | {label} ({query}): " + ", ".join(
                f"{k} {v:.3g}" for k, v in reading.items())
                + f"; {'rejected by ' + ', '.join(out) if out else 'passed'}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    return failed


def perray_verdicts(dev, kernels, sound, faulty):
    """Names of the per-ray kernels the limits judge wrongly; the sound
    entry points are put back after."""
    cases = list(chip_smoke.perray_cases(dev))
    wants = [chip_smoke.perray_run(kind, query, scene, args, kernel=False)
             for _, kind, scene, query, args in cases]
    failed = []
    for name, lib in [("sound", None)] + faulty:
        entries = {n: sound[n] if lib is None else entry_of(lib, n, sound[n])
                   for n in sound}
        kernels._perray_entry = lambda n, entries=entries: entries[n]
        rejected = 0
        for (label, kind, scene, query, args), want in zip(cases, wants):
            reading = chip_smoke.perray_agreement(
                query, chip_smoke.perray_run(kind, query, scene, args,
                                             poison=True),
                want, chip_smoke.dead_of(query, args))
            out = chip_smoke.rejects(reading, chip_smoke.PERRAY_LIMITS)
            rejected += bool(out)
            print(f"{name} | {label} ({kind} {query}): " + ", ".join(
                f"{k} {v:.3g}" for k, v in reading.items())
                + f"; {'rejected by ' + ', '.join(out) if out else 'passed'}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    kernels._perray_entry = lambda n: sound[n]
    return failed


def brute_verdicts(dev, kernels, sound, faulty):
    """Names of the brute-force kernels the limits judge wrongly."""
    cases = list(chip_smoke.brute_cases(dev))
    wants = [chip_smoke.brute_plain(query, prims, args)
             for _, prims, _, query, args in cases]
    failed = []
    for name, lib in [("sound", None)] + faulty:
        entries = {n: sound[n] if lib is None else entry_of(lib, n, sound[n])
                   for n in sound}
        kernels._brute_entry = lambda n, entries=entries: entries[n]
        rejected = 0
        for (label, _, tables, query, args), want in zip(cases, wants):
            reading = chip_smoke.live_agreement(
                query, chip_smoke.brute_run(query, tables, args, poison=True),
                want, chip_smoke.dead_of(query, args))
            out = chip_smoke.rejects(reading, chip_smoke.BRUTE_LIMITS)
            rejected += bool(out)
            print(f"{name} | {label} ({query}): " + ", ".join(
                f"{k} {v:.3g}" for k, v in reading.items())
                + f"; {'rejected by ' + ', '.join(out) if out else 'passed'}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    return failed


def brute_controls(dev, kernels, sound, controls):
    """Names of the brute-force controls that answer otherwise than the
    sound kernel. Each is timed beside it in turns (sound, control,
    control, sound) with the launches queued: the field's 4 closest-hit and
    8 any-hit queries of seven drifting frames with their masks, summed,
    and the soup's triangles alone on the primaries (K4e) and light 0's
    shadows (K4d)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.timing import (
        queued_ms,
    )

    res, cfg = chip_smoke.RES, RenderConfig()
    kernels._brute_entry = lambda n: sound[n]
    field = build_scene(scenes.sphere_field_scene(
        n_side=chip_smoke.FIELD_SIDE, res=res, accel=C.ACCEL_NONE),
        device=dev)
    soup = build_scene(chip_smoke.soup_scene(res=res), device=dev,
                       accel=C.ACCEL_NONE)
    tri = intersect.brute_tables(chip_smoke.subset(soup.prims, sph=False))
    fq, sq = ([chip_smoke.frame_queries(scene, *chip_smoke.camera_rays(
        scene, 0.37 * i), cfg) for i in range(7)] for scene in (field, soup))
    # (label, query, tables, the query of a frame's (closest, shadows))
    timed = ([(f"closest level {lvl}", "closest", field.brute,
               lambda x, lvl=lvl: x[0][lvl]) for lvl in range(len(fq[0][0]))]
             + [(f"any {k}", "any", field.brute, lambda x, k=k: x[1][k])
                for k in range(len(fq[0][1]))])

    def use(entries):
        kernels._brute_entry = lambda n: entries[n]

    def answers(entries):
        use(entries)
        return [chip_smoke.brute_run(query, tb, pick(fq[0]))
                for _, query, tb, pick in timed]

    def times(entries):
        use(entries)
        ms = {label: queued_ms(
            lambda *a, q=query: chip_smoke.brute_run(q, a[0], a[1:]),
            [(tb, *pick(x)) for x in fq]) for label, query, tb, pick in timed}
        for label, query, pick in (("K4e", "closest", lambda x: x[0][0]),
                                   ("K4d", "any", lambda x: x[1][0])):
            ms[label] = queued_ms(
                lambda *a, q=query: chip_smoke.brute_run(q, a[0], a[1:]),
                [(tri, *pick(x)) for x in sq])
        return ms

    want = answers(sound)
    failed = []
    for name, lib in controls:
        entries = {n: entry_of(lib, n, sound[n]) for n in sound}
        same = all(all(torch.equal(a, b) for a, b in zip(g, w))
                   if isinstance(g, tuple) else torch.equal(g, w)
                   for g, w in zip(answers(entries), want))
        print(f"control {name}: answers {'equal' if same else 'differ'}")
        if not same:
            failed.append(f"control {name}")
        for who, e in (("sound", sound), (name, entries), (name, entries),
                       ("sound", sound)):
            ms = times(e)
            closest = sum(v for k, v in ms.items() if k.startswith("closest"))
            any_hit = sum(v for k, v in ms.items() if k.startswith("any"))
            print(f"time {who}: the field's 4 closest-hit launches "
                  f"{closest:.4f} ms (level 0 {ms['closest level 0']:.4f}), "
                  f"8 any-hit launches {any_hit:.4f} ms (level 0, light 0 "
                  f"{ms['any 0']:.4f}); the soup's triangles K4e "
                  f"{ms['K4e']:.4f}, K4d {ms['K4d']:.4f} ms", flush=True)
    kernels._brute_entry = lambda n: sound[n]
    return failed


def bvh_controls(dev, kernels, sound, controls):
    """Names of the walk's design controls (BVH_DESIGN) that answer
    otherwise than the sound walk on the BVH frame's 12 launches (every
    slot, bit for bit); each is timed beside it in turns (sound, control,
    control, sound, twice), each launch on seven drifting frames' queries
    with the launches queued (tools/megakernels.walk_timed_in_turns)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        megakernels as mt,
    )

    kernels._bvh_entry = lambda n: sound[n]
    scene, frames = mt.walk_inputs(dev)
    failed = []
    for name, lib in controls:
        builds = [("sound", None, mt.walk_width(mt.kb.CSRC)),
                  (name, lib, mt.walk_width(lib.parent))]
        if not all(mt.walk_answers(scene, frames, builds).values()):
            failed.append(f"control {name}")
        mt.walk_timed_in_turns(scene, frames, builds)
    return failed


def design_controls(dev, controls):
    """Names of the megakernels' design controls (WHITTED_DESIGN,
    PT_DESIGN) that answer otherwise than the sound kernel on the main
    paths' launches; each is timed beside it in turns (sound, control,
    control, sound, twice)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        megakernels as mt,
    )

    inputs = mt.main_inputs(dev)
    failed = []
    for name, kernel, lib in controls:
        builds = [("sound", kernel, None,
                   mt.row_width(mt.kb.CSRC, kernel)),
                  (name, kernel, lib, mt.row_width(lib.parent, kernel))]
        if not all(mt.answers(inputs, builds).values()):
            failed.append(f"control {name}")
        mt.timed_in_turns(inputs, builds)
    return failed


def probe_verdicts(dev, kernels, sound, faulty):
    """Names of the probe kernels that phase 15's checks judge wrongly:
    each must pass the sound library and reject its fault (T3 on the deep
    tree, T1's cheap class by its plain version or its ceiling)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        probe_features as pf,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        roofline_mount as rm,
    )

    failed = []
    for name, lib in [("sound", None)] + faulty:
        entries = {n: sound[n] if lib is None else entry_of(lib, n, sound[n])
                   for n in sound}
        kernels._probe_entry = lambda n, entries=entries: entries[n]
        verdicts = []
        try:
            pf.check_walks(dev, pf.FIELD_DEPTH)
            verdicts.append("walk passed")
        except AssertionError as e:
            verdicts.append(f"walk rejected ({e})")
        try:
            rm.part_rates(dev, ops=("cheap",))
            verdicts.append("rates passed")
        except AssertionError as e:
            verdicts.append(f"rates rejected ({e})")
        rejected = sum("rejected" in v for v in verdicts)
        print(f"{name} | probes: {'; '.join(verdicts)}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    return failed


def function_verdicts(dev):
    """Names of the Whitted kernel's autograd.Function variants that phase
    26's limits (chip_smoke.function_rejects) judge wrongly: the sound
    WhittedTrace must pass every case of chip_smoke.function_cases, and a
    planted backward that drops o's and d's gradient (the rays' link to
    the camera, the lights' shadow rays and the geometry's children) must
    be rejected in every case."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_megakernel as mk,
    )

    class DropRayGrad(mk.WhittedTrace):
        @staticmethod
        def backward(ctx, grad):
            grads = list(mk.WhittedTrace.backward(ctx, grad))
            grads[3] = grads[4] = None
            return tuple(grads)

    failed = []
    for name, apply in (("sound", mk.WhittedTrace.apply),
                        ("backward without o, d", DropRayGrad.apply)):
        rejected = []
        for label, scene, cfg, s in chip_smoke.function_cases(dev):
            why = chip_smoke.function_rejects(
                chip_smoke.function_readings(apply, scene, cfg, s))
            print(f"{name} | Function {label}: "
                  f"{'; '.join(why) or 'passed'}")
            rejected.append(bool(why))
        wrong = any(rejected) if name == "sound" else not all(rejected)
        if wrong:
            failed.append(f"Function: {name}")
    return failed


def shard_verdicts(dev, backends=("gloo", "nccl")):
    """Names of the sharded paths' variants that the sharded checks
    (chip_smoke.sharded_rejects) judge wrongly. Two gloo ranks on the card
    (phase 30) must pass when sound, every path eager and compiled, and be
    rejected under each of chip_smoke.SHARD_FAULTS on the parts it touches
    (chip_smoke.SHARD_FAULT_PARTS): rank 1 writing its slice one pixel
    early into the all_reduce; the gradient all-reduce skipped, so each
    rank steps on its share of the gradient; the rank generator seeded
    once at capture, so every replay draws the capture's values; rank 1's
    slice placed one row early in the all-gather (gloo ranks check the
    all-gather on CPU copies of their slices); the last rank tracing its
    path-tracer slice one row early (only the whole frame's PT_LIMITS
    check reads it). On a box with two or more cards the NCCL ranks of
    phase 35 (one a card, up to 4) must pass too and reject the last four
    (the first is the all_reduce form's, which NCCL does not take). ``backends`` names the runs to make. Prints the
    readings that rejected each."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import launch

    # light_step's target is mount_low's compiled frame (phase 4's image)
    refs, _ = chip_smoke.shard_refs(dev, chip_smoke.light_step(dev)[1])
    every = ("mount", "train", "pt")
    runs = [] if "gloo" not in backends else [
        ("gloo", chip_smoke.SHARD_RANKS, None, every)] + [
        ("gloo", chip_smoke.SHARD_RANKS, f, parts)
        for f, parts in zip(chip_smoke.SHARD_FAULTS,
                            chip_smoke.SHARD_FAULT_PARTS)]
    cards = torch.cuda.device_count()
    if "nccl" in backends and cards >= 2:
        n = min(cards, chip_smoke.SHARD_MAX_CARDS)
        runs += [("nccl", n, None, every)] + [
            ("nccl", n, f, parts)
            for f, parts in zip(chip_smoke.SHARD_FAULTS[1:],
                                chip_smoke.SHARD_FAULT_PARTS[1:])]
    elif "nccl" in backends:
        print(f"sharded faults on NCCL across cards: not run (this box has "
              f"{cards} card)")
    failed = []
    for backend, n, fault, parts in runs:
        results = launch.run(chip_smoke.sharded_rank, n, parts, fault,
                             backend=backend,
                             timeout_s=chip_smoke.SHARD_TIMEOUT_S)
        why = chip_smoke.sharded_rejects(results, refs)
        name = fault or "sound"
        print(f"{name} | sharded {'/'.join(parts)}, {n} {backend} ranks: "
              f"{'; '.join(why) or 'passed'}")
        if (fault is None) == bool(why):
            failed.append(f"sharding ({backend}): {name}")
    return failed


def camera_leaves(spec) -> list:
    """The positions, among the tensor leaves of utils/graphs.flatten's
    ``spec``, of the leaves that lie inside a Camera."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Camera

    out, n = [], 0

    def walk(spec, inside):
        nonlocal n
        kind = spec[0]
        if kind == "tensor":
            if inside:
                out.append(n)
            n += 1
        elif kind == "dataclass":
            for _, s in spec[2]:
                walk(s, inside or spec[1] is Camera)
        elif kind == "tuple":
            for s in spec[2]:
                walk(s, inside)

    walk(spec, False)
    return out


def plant_graph_fault(fault):
    """Plant ``fault`` (one of chip_smoke.GRAPH_FAULTS) in
    utils/graphs.py; returns the function that takes it out again."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import Scene
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == chip_smoke.GRAPH_FAULTS[0]:
        sound_capture = graphs.CudaGraphs.capture

        def unregistered(self, device, run, generator, mode="global"):
            return sound_capture(self, device, run, None, mode)

        patch(graphs.CudaGraphs, "capture", unregistered)
    elif fault == chip_smoke.GRAPH_FAULTS[1]:
        def frozen(self, generator):
            if self.generator is not None:
                if not hasattr(self, "frozen"):
                    self.frozen = self.generator.get_state()
                self.generator.set_state(self.frozen)

        patch(graphs.Graph, "enter", frozen)
    elif fault == chip_smoke.GRAPH_FAULTS[2]:
        sound_call, sound_copy = graphs.GraphCache.call, graphs.Graph.copy_in
        cams = []  # the camera's leaves in the call being made

        def finding_camera(self, name, fn, args, generator=None, **kw):
            cams[:] = camera_leaves(graphs.flatten(
                args, kw.get("keep", frozenset()))[1])
            return sound_call(self, name, fn, args, generator, **kw)

        def no_camera(self, leaves):
            held = [self.inputs[i].clone() for i in cams]
            sound_copy(self, leaves)
            for i, x in zip(cams, held):
                self.inputs[i].copy_(x)

        patch(graphs.GraphCache, "call", finding_camera)
        patch(graphs.Graph, "copy_in", no_camera)
    elif fault == chip_smoke.GRAPH_FAULTS[3]:
        sound_call = graphs.GraphCache.call

        def sharing(self, name, fn, args, generator=None, **kw):
            caches = [a.cache for a in args if isinstance(a, Scene)]

            def shared(*xs):
                for x in xs:
                    if isinstance(x, Scene) and caches:
                        object.__setattr__(x, "cache", caches[0])
                return fn(*xs)

            return sound_call(self, name, shared, args, generator, **kw)

        patch(graphs.GraphCache, "call", sharing)
        patch(graphs, "WARMUP", 0)
    elif fault == chip_smoke.GRAPH_FAULTS[4]:
        sound_call = graphs.GraphCache.call

        def update_lost(self, name, fn, args, generator=None, **kw):
            if name not in ("dist.train_step", "dist.train_step_full"):
                return sound_call(self, name, fn, args, generator, **kw)

            def given(scene, target, g):
                return scene, fn(scene, target, g)[1]

            return sound_call(self, name, given, args, generator, **kw)

        patch(graphs.GraphCache, "call", update_lost)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")

    def take_out():
        for owner, name, value in reversed(undo):
            setattr(owner, name, value)

    return take_out


def graph_verdicts(dev, res=128):
    """Names of the compiled programs' variants that phase 34's checks
    (chip_smoke.graph_checks at ``res``: mount_low's megakernel frame, its
    distribution frame, the 16-frame orbit, 16 progressive path-tracer
    frames, the megakernel train step) judge wrongly: the sound programs
    must pass every check, and each of chip_smoke.GRAPH_FAULTS must fail
    one (a check that raises fails: a capture that breaks ends
    chip_smoke.py)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    failed = []
    for fault in (None, *chip_smoke.GRAPH_FAULTS):
        take_out = plant_graph_fault(fault)
        graphs.CACHE.clear()
        try:
            why = {k: v for k, v in chip_smoke.graph_checks(dev, res).items()
                   if v}
        except RuntimeError as e:  # a failed capture: what the script does
            why = {"raised": [str(e).splitlines()[0]]}
        finally:
            take_out()
            graphs.CACHE.clear()
        name = fault or "sound"
        print(f"{name} | compiled programs at {res}x{res}: "
              f"{why or 'passed'}")
        if (fault is None) == bool(why):
            failed.append(f"graphs: {name}")
    return failed


def gather_control(dev):
    """The train step's gathers against the indexing they replaced: the
    primitives' and materials' rows read by ``table[idx]`` (whose CUDA
    backward sorts the indices and adds each row's duplicates in a serial
    loop) in place of ``index_select`` (atomic adds), in
    ops/intersect.gather_prims and ops/shade.gather_materials. On mount_low
    512x512, depth 4 (chip_smoke.py phase 27's step, bench.py's gradient
    line) on the megakernel and the wavefront engines: the control's loss
    must equal the sound step's and its updated parameters agree within
    chip_smoke.GRAD_LIMIT; both are timed in turns (sound, control,
    control, sound). Returns the names of wrong verdicts."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
        mount_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        render_image,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import shade
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.timing import (
        cuda_ms,
    )

    sound = (intersect.gather_prims, shade.gather_materials)

    def indexed_prims(prims, obj_id):
        safe = obj_id.clamp(min=0).long()
        ptype = torch.where(obj_id < 0, C.INVALID, prims.ptype[safe])
        return prims.params[safe], ptype, prims.mat_id[safe]

    def indexed_materials(materials, mat_id):
        i = mat_id.long()
        return shade.MatView(*(getattr(materials, f)[i]
                               for f in shade.MatView._fields))

    def use(pair):
        intersect.gather_prims, shade.gather_materials = pair

    scene = build_scene(mount_scene(res=chip_smoke.RES), device=dev)
    scales = dist.lr_scales(materials=1.0, light_pos=1.0, camera=1.0,
                            geometry=0.0)
    failed = []
    for engine in ("megakernel", "wavefront"):
        cfg = RenderConfig(engine=engine)
        target = render_image(scene, cfg)
        args = [(scene, target + 1e-7 * i, cfg, chip_smoke.BENCH_LR, None,
                 scales) for i in range(5)]
        out, times = {}, {"sound": [], "control": []}
        try:
            for name in ("sound", "control", "control", "sound"):
                use(sound if name == "sound" else (indexed_prims,
                                                   indexed_materials))
                out[name] = dist.train_step_full(*args[0])
                times[name].append(cuda_ms(dist.train_step_full, args,
                                           warmup=1))
        finally:
            use(sound)
        (s_a, l_a), (s_b, l_b) = out["sound"], out["control"]
        err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                  for a, b in zip(dist.tree_leaves(dist.params_of(s_a)),
                                  dist.tree_leaves(dist.params_of(s_b))))
        same = float(l_a) == float(l_b) and err <= chip_smoke.GRAD_LIMIT[0]
        print(f"gather control, train step {engine} mount_low "
              f"{chip_smoke.RES}x{chip_smoke.RES}: index_select "
              f"{times['sound']} ms, table[idx] {times['control']} ms "
              "(median of 5 steps each, in turns); losses equal "
              f"{float(l_a) == float(l_b)}, updated parameters' largest "
              f"relative difference {err:.3g}")
        if not same:
            failed.append(f"gather control {engine}")
    return failed


def perray_only(dev) -> list:
    """perray_verdicts alone: the sound per-ray kernels and a copy with
    each of PERRAY_FAULTS (one nvcc each, started together); returns the
    names the limits judge wrongly."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.kernels import build as kb

    names = ("median_bvh_closest_launch", "median_bvh_any_launch",
             "grid_closest_launch", "grid_any_launch")
    with concurrent.futures.ThreadPoolExecutor(
            len(PERRAY_FAULTS) + 1) as pool:
        sound = pool.submit(lambda: {n: kernels._perray_entry(n)
                                     for n in names})
        libs = list(pool.map(lambda j: kb.build_copy(
            "perray_traverse", f"fault{j[0]}", [j[1][1:]]),
            enumerate(PERRAY_FAULTS)))
    failed = perray_verdicts(dev, kernels, sound.result(),
                             [(f[0], lib) for f, lib in zip(PERRAY_FAULTS,
                                                            libs)])
    print("per-ray faults: " + (
        "the limits pass the sound kernels and reject every fault"
        if not failed else f"wrong verdict for: {', '.join(failed)}"))
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_faults: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.kernels import build as kb

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    jobs = ([("whitted_megakernel", i, f)
             for i, f in enumerate(WHITTED_FAULTS)]
            + [("pt_megakernel", i, f) for i, f in enumerate(PT_FAULTS)]
            + [("bvh_walk", i, f) for i, f in enumerate(BVH_FAULTS)]
            + [("brute_intersect", i, f) for i, f in enumerate(BRUTE_FAULTS)]
            + [("probes", i, f) for i, f in enumerate(PROBE_FAULTS)]
            + [("perray_traverse", i, f)
               for i, f in enumerate(PERRAY_FAULTS)])
    control_jobs = [(f"control{i}", edits, drop)
                    for i, (_, edits, drop, _) in enumerate(WHITTED_CONTROLS)]
    brute_control_jobs = [(f"control{i}", edits)
                          for i, (_, edits) in enumerate(BRUTE_CONTROLS)]
    design_jobs = ([("whitted_megakernel", f"design{i}", c)
                    for i, c in enumerate(WHITTED_DESIGN)]
                   + [("pt_megakernel", f"design{i}", c)
                      for i, c in enumerate(PT_DESIGN)])
    bvh_design_jobs = [(f"design{i}", edits)
                       for i, (_, edits) in enumerate(BVH_DESIGN)]
    bvh_names = ("bvh_closest_launch", "bvh_any_launch")
    brute_names = ("brute_closest_launch", "brute_any_launch",
                   "brute_scratch_bytes")
    probe_names = ("op_rate_launch", "fma_peak_launch", "stack_walk_launch")
    perray_names = ("median_bvh_closest_launch", "median_bvh_any_launch",
                    "grid_closest_launch", "grid_any_launch")
    with concurrent.futures.ThreadPoolExecutor(
            len(jobs) + len(control_jobs) + len(brute_control_jobs)
            + len(design_jobs) + len(bvh_design_jobs) + 6) as pool:
        whitted_sound = pool.submit(kernels._whitted_entry)
        pt_sound = pool.submit(kernels._pt_entry)
        bvh_sound = pool.submit(lambda: {n: kernels._bvh_entry(n)
                                         for n in bvh_names})
        brute_sound = pool.submit(lambda: {n: kernels._brute_entry(n)
                                           for n in brute_names})
        probe_sound = pool.submit(lambda: {n: kernels._probe_entry(n)
                                           for n in probe_names})
        perray_sound = pool.submit(lambda: {n: kernels._perray_entry(n)
                                            for n in perray_names})
        control_libs = [pool.submit(kb.build_copy, "whitted_megakernel", *j)
                        for j in control_jobs]
        brute_control_libs = [
            pool.submit(kb.build_copy, "brute_intersect", *j)
            for j in brute_control_jobs]
        design_libs = [pool.submit(kb.build_copy, src, tag, edits)
                       for src, tag, (_, edits) in design_jobs]
        bvh_design_libs = [pool.submit(kb.build_copy, "bvh_walk", *j)
                           for j in bvh_design_jobs]
        libs = list(pool.map(
            lambda j: kb.build_copy(j[0], f"fault{j[1]}", [j[2][1:]]), jobs))
    controls = [(name, lib.result(), verdict) for (name, _, _, verdict), lib
                in zip(WHITTED_CONTROLS, control_libs)]
    faulty = {src: [(f[0], lib) for (s, _, f), lib in zip(jobs, libs)
                    if s == src]
              for src in ("whitted_megakernel", "pt_megakernel", "bvh_walk",
                          "brute_intersect", "probes", "perray_traverse")}
    failed = (whitted_verdicts(dev, kernels, whitted_sound.result(),
                               faulty["whitted_megakernel"])
              + frame_verdicts(dev, kernels, whitted_sound.result(),
                               faulty["whitted_megakernel"], controls)
              + pt_verdicts(dev, kernels, pt_sound.result(),
                            faulty["pt_megakernel"])
              + bvh_verdicts(dev, kernels, bvh_sound.result(),
                             faulty["bvh_walk"])
              + bvh_controls(dev, kernels, bvh_sound.result(),
                             [(name, lib.result()) for (name, _), lib
                              in zip(BVH_DESIGN, bvh_design_libs)])
              + brute_verdicts(dev, kernels, brute_sound.result(),
                               faulty["brute_intersect"])
              + brute_controls(dev, kernels, brute_sound.result(),
                               [(name, lib.result()) for (name, _), lib
                                in zip(BRUTE_CONTROLS, brute_control_libs)])
              + probe_verdicts(dev, kernels, probe_sound.result(),
                               faulty["probes"])
              + perray_verdicts(dev, kernels, perray_sound.result(),
                                faulty["perray_traverse"])
              + function_verdicts(dev)
              + shard_verdicts(dev)
              + graph_verdicts(dev)
              + gather_control(dev)
              + design_controls(dev, [(c[0], src, lib.result()) for
                                      (src, _, c), lib in zip(design_jobs,
                                                              design_libs)]))
    print(f"chip_faults ({card}): " + (
        "the limits pass the sound kernels and reject every fault"
        if not failed else f"wrong verdict for: {', '.join(failed)}"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
