// Whitted megakernel for Hopper (sm_90a): the whole depth-D recursion tree
// of every primary ray in one kernel.
//
// Replaces two TPU kernels of the JAX package that compute this function:
//   u_4a_2s_p3d_raytracer_template2_tpu/models/whitted_megakernel.py
//     _build_kernel          (scene baked in as immediates)
//   u_4a_2s_p3d_raytracer_template2_tpu/models/whitted_streamed.py
//     _build_streamed_kernel (scene read from SMEM tables)
// The scene arrives as the streamed kernel's tables: [N*24] primitive rows
// (12 params, 11 material fields and a pad, in tri, sphere, plane, box
// order), [L*6] lights, [3] background, so one build serves every scene.
//
// Distribution mode (models/samples.py): the primary rays of a subpixel
// (jittered, thin lens) are made outside, and the random values of the tree
// arrive as [n_rows, n_rays] stream rows in the layout of the JAX package's
// _stream_layout: node (lvl, path) owns 2 rows per light (the jittered
// light offset of soft shadows under AA) and, where it spawns, 3 rows (the
// unit-sphere perturbation of fuzzy reflection). The sky on a miss is a
// nearest-texel lookup in the cubemap ([6, H, W, 3] u8 or f32) in device
// memory, in place of the JAX kernel's deferred-sky epilogue and packed-u32
// texels (Mosaic has no per-lane gather; a GPU thread reads its texel).
//
// What bounds it: a frame moves 36 B per ray (24 in, 12 out), 9.4 MB at
// 512x512, which the card's memory moves in a few microseconds; a
// distribution frame adds the stream rows (4 B per row and ray, 53.5 MB a
// subpixel for mount_low at depth 4 with soft shadows and fuzzy reflection)
// and a 3-byte texel per miss. The work is arithmetic: for mount_low at
// depth 4 a pixel walks 1.8 nodes on average and up to 15, each a
// closest-hit test over every primitive and a shadow test per light. On
// the card it runs far from that bound, and not for lack of issue slots:
// the 64-, 128- and 256-thread launches take the same time, and what a
// node costs is the latency of one thread's dependent chain at 16 warps an
// SM (PERF.md). The design follows from that:
//   * one thread per ray; the tables are copied into shared memory at block
//     start, and every thread of a warp reads the same primitive at the same
//     time, so the reads are broadcasts, 16 bytes at a time (ld4: a row is
//     three float4 of geometry and three of material);
//   * the tree is walked depth first, and a miss ends its path: a thread
//     skips every subtree that never spawns, where the TPU kernel masked all
//     lanes through all nodes;
//   * the triangle and sphere tests are prim_tests.cuh's, split at their
//     gates: a walk runs the gates of kGroup rows of a type as one
//     straight run of independent chains and branches once, and only an
//     open gate pays for the rest (a sphere's square root and divisions, a
//     triangle's v and t); the fold over the group keeps table order and
//     strict <, so the winner and the tie rule are a one-at-a-time fold's.
//     Two rows a step beat one and four (four hold more registers);
//   * the closest hit and the shadow test share that walk; the shadow
//     test stops at the first occluder, and light_sample has one call
//     site, so it is compiled once;
//   * pending refraction children wait on a stack of at most max_depth-1
//     entries in the thread's local memory (an array indexed by its size),
//     not in registers: the registers go to the tests, no template depth
//     spills, and five blocks of 128 fit an SM (kMinBlocks); an entry
//     carries its node's (lvl, path) packed in one int,
//     the key of its stream rows: with both branches the reflection child
//     of path p is 2p and the refraction child 2p+1, with one branch the
//     child is p.
// Color is the linear fold local + KR*spec*refl + (1-KR)*refr of
// whitted_megakernel.py:551-577, accumulated as weight*local along each path;
// leaf colors are clamped, and so is the pixel. All math is f32, IEEE
// division and square root (no fast math), built without multiply-add
// contraction (kernels/build.NO_CONTRACTION): a sky texel is picked by
// truncating a face coordinate, so the directions must round as the plain
// version's do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prim_tests.cuh"

namespace {

constexpr int kTblW = 24;               // floats a row (TBL_W)
constexpr int kThreads = 128;
constexpr int kMinBlocks = 5;           // resident blocks an SM ptxas plans for
constexpr int kGroup = 2;               // triangles or spheres a step of a walk
constexpr int kMaxDepth = 8;
constexpr float kTwoPi = 6.28318530718f;  // ops/sampling.TWO_PI
constexpr float kU8Scale = 255.99f;       // u8tofloat (maths.h)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 xyz(float4 p) { return {p.x, p.y, p.z}; }

// The k-th 16 bytes of a table row: rows are kTblW floats, 16-byte aligned,
// three float4 of geometry and three of material.
__device__ __forceinline__ float4 ld4(const float* row, int k) {
  return reinterpret_cast<const float4*>(row)[k];
}

// zero vectors map to zero, as core/types.normalize
__device__ __forceinline__ V3 normalize(V3 a) {
  float n2 = dot(a, a);
  if (!(n2 > 0.f)) return v3(0.f, 0.f, 0.f);
  float n = sqrtf(n2);
  return {a.x / n, a.y / n, a.z / n};
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }
__device__ __forceinline__ V3 clamp01(V3 a) { return {clamp01(a.x), clamp01(a.y), clamp01(a.z)}; }

// 1/d with zero components mapped to +-1e30 (ops/intersect._safe_inv)
__device__ __forceinline__ float safe_inv(float x) {
  if (fabsf(x) < 1e-30f) return x < 0.f ? -1e30f : 1e30f;
  return 1.f / x;
}

// A ray of prim_tests.cuh: a = d.d and a4 = 4a as the plain version's
// sphere test forms them (d need not be unit: shadow rays run along the
// unnormalized L).
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float a, a4;
};

__device__ __forceinline__ Ray make_ray(V3 o, V3 d) {
  const float a = dot(d, d);
  return {o.x, o.y, o.z, d.x, d.y, d.z, a, 4.f * a};
}

// ---------------------------------------------------------------------------
// plane and box tests over a row's geometry; BIG on miss
// (ops/intersect._*_t_one); the triangle and sphere tests are
// prim_tests.cuh's

__device__ __forceinline__ float plane_t(float4 p, const Ray& r) {
  const float denom = r.dx * p.x + r.dy * p.y + r.dz * p.z;
  if (!(fabsf(denom) > kEps)) return kBig;
  const float t = -((r.ox * p.x + r.oy * p.y + r.oz * p.z) + p.w) / denom;
  return t > 0.f ? t : kBig;
}

__device__ __forceinline__ void slab(float lo_p, float hi_p, float o, float inv,
                                     float& tmin, float& tmax) {
  float lo = (lo_p - o) * inv;
  float hi = (hi_p - o) * inv;
  bool pos = inv >= 0.f;
  tmin = pos ? lo : hi;
  tmax = pos ? hi : lo;
}

// a box row: lo in p0.xyz, hi in (p0.w, p1.x, p1.y)
__device__ __forceinline__ float box_t(float4 p0, float4 p1, V3 o, V3 inv) {
  float tn0, tx0, tn1, tx1, tn2, tx2;
  slab(p0.x, p0.w, o.x, inv.x, tn0, tx0);
  slab(p0.y, p1.x, o.y, inv.y, tn1, tx1);
  slab(p0.z, p1.y, o.z, inv.z, tn2, tx2);
  float t_in = fmaxf(fmaxf(tn0, tn1), tn2);
  float t_out = fminf(fminf(tx0, tx1), tx2);
  if (!(t_in < t_out && t_out > kEps)) return kBig;
  return t_in > kEps ? t_in : t_out;
}

// entry or exit face normal (ops/intersect.per_ray_normal): the first axis
// of the largest entry / smallest exit slab, signed by that slab's t
__device__ __forceinline__ V3 box_normal(float4 p0, float4 p1, V3 o, V3 d) {
  float tn0, tx0, tn1, tx1, tn2, tx2;
  slab(p0.x, p0.w, o.x, safe_inv(d.x), tn0, tx0);
  slab(p0.y, p1.x, o.y, safe_inv(d.y), tn1, tx1);
  slab(p0.z, p1.y, o.z, safe_inv(d.z), tn2, tx2);
  // scalar argmax/argmin (first index on ties): no dynamically indexed array
  int ax_in = 0, ax_out = 0;
  float t_in = tn0, t_out = tx0;
  if (tn1 > t_in) { ax_in = 1; t_in = tn1; }
  if (tn2 > t_in) { ax_in = 2; t_in = tn2; }
  if (tx1 < t_out) { ax_out = 1; t_out = tx1; }
  if (tx2 < t_out) { ax_out = 2; t_out = tx2; }
  const bool use_in = t_in > kEps;
  const int ax = use_in ? ax_in : ax_out;
  const float s = (use_in ? t_in : t_out) < 0.f ? -1.f : 1.f;
  return v3(ax == 0 ? s : 0.f, ax == 1 ? s : 0.f, ax == 2 ? s : 0.f);
}

// ---------------------------------------------------------------------------
// the skybox (ops/shade.cubemap_index, skybox_color; scene.cpp:383-461)

struct Sky {
  const void* tex;  // [6, h, w, 3] u8 or f32, or null (flat background)
  int h, w, f32;
};

// Nearest texel of direction d: dominant axis with z checked last under
// strict >, LEFT at X=+1, 1/max(ma, 1e-20), truncation toward zero, then
// clip.
__device__ __forceinline__ V3 sky_color(const Sky& sky, V3 d) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const bool use_x = ax > ay;
  float ma = use_x ? ax : ay;
  int side = use_x ? (d.x >= 0.f ? 1 : 0) : (d.y >= 0.f ? 2 : 3);
  if (az > ma) {
    ma = az;
    side = d.z >= 0.f ? 4 : 5;
  }
  float sc, tc;
  switch (side) {
    case 0: sc = -d.z; tc = d.y; break;
    case 1: sc = d.z; tc = d.y; break;
    case 2: sc = -d.x; tc = -d.z; break;
    case 3: sc = -d.x; tc = d.z; break;
    case 4: sc = -d.x; tc = d.y; break;
    default: sc = d.x; tc = d.y; break;
  }
  const float inv = 1.f / fmaxf(ma, 1e-20f);
  const float s = (sc * inv + 1.f) * 0.5f;
  const float t = (tc * inv + 1.f) * 0.5f;
  int xp = (int)((float)(sky.w - 1) * s);
  int yp = (int)((float)(sky.h - 1) * t);
  xp = min(max(xp, 0), sky.w - 1);
  yp = min(max(yp, 0), sky.h - 1);
  const size_t k = 3 * (((size_t)side * sky.h + yp) * sky.w + xp);
  if (sky.f32) {
    const float* p = static_cast<const float*>(sky.tex) + k;
    return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
  }
  // u8tofloat: byte / 255.99 after the gather
  const unsigned char* p = static_cast<const unsigned char*>(sky.tex) + k;
  return v3((float)__ldg(p) / kU8Scale, (float)__ldg(p + 1) / kU8Scale,
            (float)__ldg(p + 2) / kU8Scale);
}

struct SceneView {
  const float* tbl;  // kTblW floats a row
  const float* lt;
  V3 bg;
  int n_tri, n_sph, n_pl, n_box, n_lights;
};

// Visit the rows in tri, sphere, plane, box order with each test's t (kBig
// on a miss) until visit(row, t) returns true; returns whether it did.
// Triangles and spheres go kGroup rows a step: the gates of the group's
// tests run as one straight run of independent operations, then one
// branch finishes the open ones in table order. A closed gate's test is a
// miss, which neither walk below needs to see.
template <class Visit>
__device__ __forceinline__ bool walk(const SceneView& s, const Ray& r, Visit visit) {
  const float* row = s.tbl;
  int i = 0;
  for (; i + kGroup <= s.n_tri; i += kGroup) {
    TriGate g[kGroup];
    bool open = false;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float* p = row + (i + k) * kTblW;
      g[k] = triangle_gate(ld4(p, 0), ld4(p, 1), ld4(p, 2), r);
      open |= g[k].open();
    }
    if (open) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const float* p = row + (i + k) * kTblW;
        if (g[k].open() &&
            visit(i + k, g[k].t(ld4(p, 0), ld4(p, 1), ld4(p, 2), r)))
          return true;
      }
    }
  }
  for (; i < s.n_tri; ++i) {
    const float* p = row + i * kTblW;
    if (visit(i, triangle_t(ld4(p, 0), ld4(p, 1), ld4(p, 2), r))) return true;
  }
  const int sph_end = s.n_tri + s.n_sph;
  for (; i + kGroup <= sph_end; i += kGroup) {
    Gate g[kGroup];
    bool open = false;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float4 p = ld4(row + (i + k) * kTblW, 0);
      g[k] = sphere_gate(p, p.w * p.w, r);
      open |= g[k].open();
    }
    if (open) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (g[k].open() && visit(i + k, g[k].t(r))) return true;
    }
  }
  for (; i < sph_end; ++i)
    if (visit(i, sphere_t(ld4(row + i * kTblW, 0), r))) return true;
  const int pl_end = sph_end + s.n_pl;
  for (; i < pl_end; ++i)
    if (visit(i, plane_t(ld4(row + i * kTblW, 0), r))) return true;
  if (s.n_box > 0) {
    const V3 o = v3(r.ox, r.oy, r.oz);
    const V3 inv = v3(safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz));
    for (; i < pl_end + s.n_box; ++i) {
      const float* p = row + i * kTblW;
      if (visit(i, box_t(ld4(p, 0), ld4(p, 1), o, inv))) return true;
    }
  }
  return false;
}

// Strict-< fold in table order, which picks the row a fold one at a time
// picks, ties included; returns the row or -1.
__device__ __forceinline__ int closest(const SceneView& s, const Ray& r, float& t_best) {
  t_best = kBig;
  int best = -1;
  walk(s, r, [&](int i, float t) {
    if (t < t_best) { t_best = t; best = i; }
    return false;
  });
  return best;
}

// any hit with t < max_t; stops at the first occluder
__device__ __forceinline__ bool occluded(const SceneView& s, const Ray& r, float max_t) {
  return walk(s, r, [&](int, float t) { return t < max_t; });
}

struct Mat {
  V3 diff, spec;
  float kd, ks, shine, transmit, ior;
};

// processLight for one light position (main.cpp:471-526): the shadow ray
// starts at `precise` and runs along the unnormalized L, so max_t = 1 bounds
// it at the light
__device__ __forceinline__ V3 light_sample(const SceneView& s, V3 lpos, V3 lcol, V3 hp,
                           V3 precise, V3 n, V3 d, const Mat& m, float max_t) {
  V3 L = lpos - hp;
  if (!(dot(L, n) > 0.f)) return v3(0.f, 0.f, 0.f);
  if (occluded(s, make_ray(precise, L), max_t)) return v3(0.f, 0.f, 0.f);
  V3 Lh = normalize(L);
  V3 H = normalize(Lh + normalize(-d));
  float ndl = fmaxf(0.f, dot(n, Lh));
  float vdn = fmaxf(0.f, dot(H, n));
  float sp = vdn > 0.f ? powf(vdn, m.shine) : (m.shine == 0.f ? 1.f : 0.f);
  return (lcol * m.diff * ndl) * m.kd + (lcol * m.spec * sp) * (m.ks * 0.4f);
}

// The jittered light offsets of soft shadows under AA, tied to the
// subpixel (si, sj) of spp (main.cpp:621-624; models/samples.stream_rows)
struct Jitter {
  const float* u;  // this node's first stream row at this ray, stride n_rays
  int n_rays;
  float si, sj;
  int spp;
};

// `jit.u` null: no jittered soft shadows
// One call site of light_sample, so the walk to the first occluder is
// compiled once: a light is one position, or with the soft-shadow grid 16.
__device__ __forceinline__ V3 direct_light(const SceneView& s, V3 hp, V3 precise, V3 n, V3 d,
                           const Mat& m, float max_t, bool soft_grid,
                           const Jitter& jit) {
  V3 col = v3(0.f, 0.f, 0.f);
  const bool grid = jit.u == nullptr && soft_grid;
  for (int li = 0; li < s.n_lights; ++li) {
    const V3 lpos = load3(s.lt + 6 * li);
    const V3 lcol = load3(s.lt + 6 * li + 3);
    V3 pos = lpos;
    if (jit.u != nullptr) {
      // one jittered light position tied to the AA subpixel, the whole
      // light color: offset 0.5 * ((i + u) / spp)
      const float ux = __ldg(jit.u + (size_t)(2 * li) * jit.n_rays);
      const float uy = __ldg(jit.u + (size_t)(2 * li + 1) * jit.n_rays);
      const float jx = 0.5f * ((jit.si + ux) / (float)jit.spp);
      const float jy = 0.5f * ((jit.sj + uy) / (float)jit.spp);
      pos = lpos + v3(jx, jy, 0.f);
    }
    // the 4x4 grid of light positions, each 1/16 of the color
    // (main.cpp:601-618): spacing 0.125, start at pos - 0.25, row by row
    const V3 c = grid ? lcol * (1.f / 16.f) : lcol;
    for (int k = 0; k < (grid ? 16 : 1); ++k) {
      if (grid)
        pos = lpos + v3(-0.25f + 0.125f * (k & 3), -0.25f + 0.125f * (k >> 2), 0.f);
      col = col + light_sample(s, pos, c, hp, precise, n, d, m, max_t);
    }
  }
  return col;
}

// ---------------------------------------------------------------------------
// the tree walk

struct Entry {
  V3 o, d, w;
  float ior;
  int key;  // entry_key: the node's depth (lvl + 1) and path
};

// depth in 1..8 in the low 4 bits, the node's index within its level (the
// stream rows' key, below 2^7) above them
__device__ __forceinline__ int entry_key(int depth, int path) { return path << 4 | depth; }

// Pending refraction children, LIFO. Entries hold strictly increasing
// depths in 2..MAXD, so CAP = MAXD-1 suffices. The array is indexed by the
// stack's size, so it lives in the thread's local memory (cached in L1):
// a walk pushes at most one entry a refracting node, and the 11 words an
// entry stay out of the register file the tests need.
template <int CAP>
struct Stack {
  Entry e[CAP];
  int size = 0;
  __device__ __forceinline__ void push(const Entry& x) { e[size++] = x; }
  __device__ __forceinline__ Entry pop() { return e[--size]; }
};

struct Params {
  const float* ray_o;
  const float* ray_d;
  float* out;
  int n_rays;
  const float* tbl;
  const float* lt;
  const float* bg;
  int n_tri, n_sph, n_pl, n_box, n_lights;
  int has_refl, has_refr;
  int fresnel_mode;     // 0 schlick, 1 reference_schlick, 2 reference_exact
  int refraction_mode;  // 0 reference, 1 physical
  int shadow_unbounded;
  int soft_grid;        // soft shadows without AA: the 4x4 light grid
  const float* rows;    // [n_rows, n_rays] stream rows, or null
  int soft_jit;         // soft shadows with AA: 2 rows a light and node
  int fuzzy;            // fuzzy reflection: 3 rows a spawning node
  float roughness;
  float si, sj;         // the subpixel's AA indices
  int spp;
  Sky sky;
};

// Inside the unit sphere from three U[0,1) draws, cube-root radius
// (ops/sampling.unit_sphere_from_uniforms, common.glsl:78-84)
__device__ __forceinline__ V3 unit_sphere(float u1, float u2, float u3) {
  const float x = u1 * 2.f - 1.f;
  const float phi = u2 * kTwoPi;
  const float r = cbrtf(u3);
  const float s = sqrtf(fmaxf(1.f - x * x, 0.f));
  return v3(r * (s * sinf(phi)), r * (s * cosf(phi)), r * x);
}

// Rows of node (lvl, *) and the first row of node (lvl, path) in the
// layout of models/samples.stream_layout: levels in order, each level's
// nodes in path order, a node's shadow rows before its fuzzy rows.
__device__ __forceinline__ int rows_per_node(const Params& P, int lvl, int n_levels) {
  return (P.soft_jit ? 2 * P.n_lights : 0) + (P.fuzzy && lvl < n_levels - 1 ? 3 : 0);
}

__device__ __forceinline__ int node_row(const Params& P, int lvl, int path,
                                        int n_levels, int branch) {
  int base = 0, w = 1;
  for (int l = 0; l < lvl; ++l) {
    base += w * rows_per_node(P, l, n_levels);
    w *= branch;
  }
  return base + path * rows_per_node(P, lvl, n_levels);
}

// kMinBlocks resident blocks an SM caps a thread's registers at
// 65536 / (kThreads * kMinBlocks).
template <int MAXD>
__global__ void __launch_bounds__(kThreads, kMinBlocks) whitted_kernel(Params P) {
  extern __shared__ float4 smem[];  // 16-byte aligned rows
  const int n = P.n_tri + P.n_sph + P.n_pl + P.n_box;
  const int n_lt = 6 * (P.n_lights > 1 ? P.n_lights : 1);
  float* s_tbl = reinterpret_cast<float*>(smem);
  float* s_lt = s_tbl + n * kTblW;
  for (int k = threadIdx.x; k < n * kTblW; k += blockDim.x) s_tbl[k] = P.tbl[k];
  for (int k = threadIdx.x; k < n_lt; k += blockDim.x) s_lt[k] = P.lt[k];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P.n_rays) return;

  SceneView s{s_tbl, s_lt, load3(P.bg), P.n_tri, P.n_sph, P.n_pl, P.n_box,
              P.n_lights};
  const float max_t = P.shadow_unbounded ? kBig : 1.f;
  const bool secondary = P.has_refl || P.has_refr;
  const int n_levels = secondary ? MAXD : 1;
  const int branch = (P.has_refl && P.has_refr) ? 2 : 1;
  const bool streamed = P.soft_jit || P.fuzzy;

  V3 o = load3(P.ray_o + 3 * r);
  V3 d = load3(P.ray_d + 3 * r);
  V3 w = v3(1.f, 1.f, 1.f);
  float ior = 1.f;
  int depth = 1;
  int path = 0;
  V3 acc = v3(0.f, 0.f, 0.f);
  Stack<(MAXD > 1 ? MAXD - 1 : 1)> stack;

  while (true) {
    bool descend = false;
    float t;
    const int id = closest(s, make_ray(o, d), t);
    if (id < 0) {
      acc = acc + w * (P.sky.tex != nullptr ? sky_color(P.sky, d) : s.bg);
    } else {
      const float* p = s_tbl + id * kTblW;
      const V3 hp = o + d * t;
      V3 nrm;
      if (id < P.n_tri) {
        const float4 g2 = ld4(p, 2);
        nrm = v3(g2.y, g2.z, g2.w);
      } else if (id < P.n_tri + P.n_sph) {
        nrm = normalize(hp - xyz(ld4(p, 0)));
      } else if (id < P.n_tri + P.n_sph + P.n_pl) {
        nrm = xyz(ld4(p, 0));
      } else {
        nrm = box_normal(ld4(p, 0), ld4(p, 1), o, d);
      }
      nrm = normalize(nrm);
      const V3 precise = hp + nrm * kEps;
      // diff(3) spec(3) kd ks shine transmit ior, then a pad
      const float4 m0 = ld4(p, 3), m1 = ld4(p, 4), m2 = ld4(p, 5);
      Mat m{xyz(m0), v3(m0.w, m1.x, m1.y), m1.z, m1.w, m2.x, m2.y, m2.z};
      // this node's stream rows at this ray
      const float* node = streamed
          ? P.rows + (size_t)node_row(P, depth - 1, path, n_levels, branch) * P.n_rays + r
          : nullptr;
      const Jitter jit{P.soft_jit ? node : nullptr, P.n_rays, P.si, P.sj, P.spp};
      V3 local = direct_light(s, hp, precise, nrm, d, m, max_t, P.soft_grid, jit);

      const bool leaf = depth >= MAXD;
      if (leaf || !secondary) {
        // depth cap clamps local (main.cpp:632-634)
        acc = acc + w * (leaf ? clamp01(local) : local);
      } else {
        acc = acc + w * local;
        // flipped normal for the secondary rays (main.cpp:639-643)
        const bool inside = dot(d, nrm) > 0.f;
        const V3 nf = inside ? -nrm : nrm;
        // the children's paths, the keys of their stream rows: with both
        // branches the reflection child of p is 2p, the refraction child 2p+1
        const int refl_path = branch == 2 ? 2 * path : path;
        const int refr_path = branch == 2 ? 2 * path + 1 : path;
        float kr = m.ks;
        if (P.has_refr && m.transmit != 0.f) {
          // refraction (main.cpp:671-697) and Fresnel KR (main.cpp:699-717)
          const V3 V = -d;
          const float ndv = dot(nf, V);
          const V3 vt = nf * ndv - V;
          const float mior = m.ior > 0.f ? m.ior : 1.f;
          const float eta = inside ? ior : ior / mior;
          const float cos_i = fabsf(ndv);
          const float sin_t = eta * sqrtf(fmaxf(dot(vt, vt), 1e-24f));
          const float insq = 1.f - sin_t * sin_t;
          const bool can = insq > 0.f;
          const float new_ior = inside ? 1.f : mior;
          if (P.fresnel_mode == 2) {
            kr = 0.f;
          } else if (can) {
            float r0 = (ior - new_ior) / (ior + new_ior);
            r0 = r0 * r0;
            kr = r0 + (1.f - r0) * powf(1.f - cos_i, 5.f);
          } else {
            kr = P.fresnel_mode == 0 ? 1.f : 0.f;
          }
          if (can) {
            const V3 t_hat = normalize(vt);
            V3 rd;
            if (P.refraction_mode == 1) {
              rd = normalize(t_hat * sin_t - nf * sqrtf(insq));
            } else {
              rd = t_hat * sin_t + nf;
            }
            stack.push(Entry{hp + rd * 0.001f, rd, w * (1.f - kr), new_ior,
                             entry_key(depth + 1, refr_path)});
          }
        }
        if (P.has_refl && m.ks > 0.f) {
          // reflection child continues inline (main.cpp:646-667)
          V3 rd = normalize(d - nf * (2.f * dot(d, nf)));
          if (P.fuzzy) {
            // perturbation by the node's unit-sphere sample, kept only in
            // the normal's hemisphere (main.cpp:651-660)
            const float* u = node + (size_t)(P.soft_jit ? 2 * P.n_lights : 0) * P.n_rays;
            const V3 sph = unit_sphere(__ldg(u), __ldg(u + P.n_rays),
                                       __ldg(u + 2 * (size_t)P.n_rays));
            const V3 fz = normalize(rd + sph * P.roughness);
            if (dot(fz, nf) > 0.f) rd = fz;
          }
          d = rd;
          o = precise;
          w = w * (m.spec * kr);
          depth += 1;
          path = refl_path;
          descend = true;
        }
      }
    }
    if (descend) continue;
    if (stack.size == 0) break;
    const Entry e = stack.pop();
    o = e.o;
    d = e.d;
    w = e.w;
    ior = e.ior;
    depth = e.key & 15;
    path = e.key >> 4;
  }

  acc = clamp01(acc);
  P.out[3 * r + 0] = acc.x;
  P.out[3 * r + 1] = acc.y;
  P.out[3 * r + 2] = acc.z;
}

template <int MAXD>
int launch(const Params& P, size_t smem, cudaStream_t stream) {
  auto kernel = whitted_kernel<MAXD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (P.n_rays + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// contiguous f32: ray_o, ray_d, out [n_rays*3]; tbl [n*24], 16-byte
// aligned; lt
// [max(1,n_lights)*6]; bg [3]; rows [n_rows*n_rays] raw U[0,1) draws (null
// when neither soft_jit nor fuzzy) of the subpixel (si, sj) of spp; sky
// [6*sky_h*sky_w*3] u8 (sky_f32 = 0) or f32, or null for the flat
// background. Launches on `stream` on the caller's
// current device (the caller selects it), does not synchronise, and
// returns the cudaError_t of the launch (0 = success).
extern "C" int whitted_megakernel_launch(
    void* stream, const float* ray_o, const float* ray_d,
    float* out, int n_rays, const float* tbl, const float* lt,
    const float* bg, int n_tri, int n_sph, int n_pl, int n_box, int n_lights,
    int has_refl, int has_refr, int max_depth, int fresnel_mode,
    int refraction_mode, int shadow_unbounded, int soft_grid,
    const float* rows, int soft_jit, int fuzzy, float roughness, float si,
    float sj, int spp, const void* sky, int sky_h, int sky_w, int sky_f32) {
  if (n_rays <= 0) return 0;
  if ((soft_jit || fuzzy) && rows == nullptr) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(tbl) % 16) return (int)cudaErrorMisalignedAddress;
  Params P{ray_o, ray_d, out, n_rays, tbl, lt, bg,
           n_tri, n_sph, n_pl, n_box, n_lights,
           has_refl, has_refr, fresnel_mode, refraction_mode,
           shadow_unbounded, soft_grid, rows, soft_jit, fuzzy, roughness,
           si, sj, spp, Sky{sky, sky_h, sky_w, sky_f32}};
  const int n = n_tri + n_sph + n_pl + n_box;
  const size_t smem =
      sizeof(float) * (size_t)(n * kTblW + 6 * (n_lights > 1 ? n_lights : 1));
  cudaStream_t st = (cudaStream_t)stream;
  static_assert(kMaxDepth == 8, "the switch below instantiates depths 1..8");
  switch (max_depth) {
    case 1: return launch<1>(P, smem, st);
    case 2: return launch<2>(P, smem, st);
    case 3: return launch<3>(P, smem, st);
    case 4: return launch<4>(P, smem, st);
    case 5: return launch<5>(P, smem, st);
    case 6: return launch<6>(P, smem, st);
    case 7: return launch<7>(P, smem, st);
    case 8: return launch<8>(P, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
