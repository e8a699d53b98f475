// Whitted megakernel for Hopper (sm_90a): the whole depth-D recursion tree
// of every primary ray in one kernel.
//
// Replaces two TPU kernels of the JAX package that compute this function:
//   u_4a_2s_p3d_raytracer_template2_tpu/models/whitted_megakernel.py
//     _build_kernel          (scene baked in as immediates)
//   u_4a_2s_p3d_raytracer_template2_tpu/models/whitted_streamed.py
//     _build_streamed_kernel (scene read from SMEM tables)
// The scene arrives as the streamed kernel's tables: [N*23] primitive rows
// (12 params + 11 material fields, in tri, sphere, plane, box order), [L*6]
// lights, [3] background, so one build serves every scene.
//
// What bounds it: a frame moves 36 B per ray (24 in, 12 out), 9.4 MB at
// 512x512, which the card's memory moves in a few microseconds. The work is
// arithmetic and divergence: for mount_low at depth 4 every pixel walks up
// to 15 nodes, each a closest-hit test over every primitive and a shadow
// test per light. The design follows from that:
//   * one thread per ray; the tables are copied into shared memory at block
//     start, and every thread of a warp reads the same primitive at the same
//     time, so the reads are broadcasts;
//   * the tree is walked depth first, and a miss ends its path: a thread
//     skips every subtree that never spawns, where the TPU kernel masked all
//     lanes through all nodes;
//   * pending refraction children wait on a stack of at most max_depth-1
//     entries; max_depth is a template parameter and the stack is a shift
//     register with compile-time indices only, so it stays in registers;
//   * the shadow test stops at the first occluder.
// Color is the linear fold local + KR*spec*refl + (1-KR)*refr of
// whitted_megakernel.py:551-577, accumulated as weight*local along each path;
// leaf colors are clamped, and so is the pixel. All math is f32, IEEE
// division and square root (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-3f;
constexpr float kBig = 1e30f;
constexpr int kTblW = 23;
constexpr int kThreads = 128;
constexpr int kMaxDepth = 8;

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
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

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

// ---------------------------------------------------------------------------
// primitive tests; BIG on miss (ops/intersect._*_t_one)

__device__ __forceinline__ float triangle_t(const float* p, V3 o, V3 d) {
  V3 e1 = load3(p + 3), e2 = load3(p + 6);
  V3 h = cross(d, e2);
  float det = dot(e1, h);
  if (!(fabsf(det) > kEps)) return kBig;
  float f = 1.f / det;
  V3 s = o - load3(p);
  float u = f * dot(s, h);
  if (!(u >= 0.f && u <= 1.f)) return kBig;
  V3 q = cross(s, e1);
  float v = f * dot(d, q);
  if (!(v >= 0.f && u + v <= 1.f)) return kBig;
  float t = f * dot(e2, q);
  return t > kEps ? t : kBig;
}

// direct (o-c) form; d need not be unit (shadow rays run along unnormalized L)
__device__ __forceinline__ float sphere_t(const float* p, V3 o, V3 d) {
  float a = dot(d, d);
  V3 l = o - load3(p);
  float b = 2.f * dot(d, l);
  float cc = dot(l, l) - p[3] * p[3];
  float delta = b * b - 4.f * a * cc;
  float sq = delta > 0.f ? sqrtf(delta) : 0.f;
  float t0 = (-b - sq) / (2.f * a);
  float t1 = (-b + sq) / (2.f * a);
  float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
  float t = lo < 0.f ? hi : lo;
  return (delta >= 0.f && t >= 0.f) ? t : kBig;
}

__device__ __forceinline__ float plane_t(const float* p, V3 o, V3 d) {
  V3 pn = load3(p);
  float denom = dot(d, pn);
  if (!(fabsf(denom) > kEps)) return kBig;
  float t = -(dot(o, pn) + p[3]) / denom;
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

__device__ __forceinline__ float box_t(const float* p, V3 o, V3 inv) {
  float tn0, tx0, tn1, tx1, tn2, tx2;
  slab(p[0], p[3], o.x, inv.x, tn0, tx0);
  slab(p[1], p[4], o.y, inv.y, tn1, tx1);
  slab(p[2], p[5], o.z, inv.z, tn2, tx2);
  float t_in = fmaxf(fmaxf(tn0, tn1), tn2);
  float t_out = fminf(fminf(tx0, tx1), tx2);
  if (!(t_in < t_out && t_out > kEps)) return kBig;
  return t_in > kEps ? t_in : t_out;
}

// entry or exit face normal (ops/intersect.per_ray_normal): the first axis
// of the largest entry / smallest exit slab, signed by that slab's t
__device__ __forceinline__ V3 box_normal(const float* p, V3 o, V3 d) {
  float tn0, tx0, tn1, tx1, tn2, tx2;
  slab(p[0], p[3], o.x, safe_inv(d.x), tn0, tx0);
  slab(p[1], p[4], o.y, safe_inv(d.y), tn1, tx1);
  slab(p[2], p[5], o.z, safe_inv(d.z), tn2, tx2);
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
// scene walks over the shared-memory table

struct SceneView {
  const float* tbl;
  const float* lt;
  V3 bg;
  int n_tri, n_sph, n_pl, n_box, n_lights;
};

// Strict-< fold in tri, sphere, plane, box order; returns the row or -1.
__device__ __forceinline__ int closest(const SceneView& s, V3 o, V3 d, float& t_best) {
  t_best = kBig;
  int best = -1;
  int i = 0;
  for (int k = 0; k < s.n_tri; ++k, ++i) {
    float t = triangle_t(s.tbl + i * kTblW, o, d);
    if (t < t_best) { t_best = t; best = i; }
  }
  for (int k = 0; k < s.n_sph; ++k, ++i) {
    float t = sphere_t(s.tbl + i * kTblW, o, d);
    if (t < t_best) { t_best = t; best = i; }
  }
  for (int k = 0; k < s.n_pl; ++k, ++i) {
    float t = plane_t(s.tbl + i * kTblW, o, d);
    if (t < t_best) { t_best = t; best = i; }
  }
  if (s.n_box > 0) {
    V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
    for (int k = 0; k < s.n_box; ++k, ++i) {
      float t = box_t(s.tbl + i * kTblW, o, inv);
      if (t < t_best) { t_best = t; best = i; }
    }
  }
  return best;
}

// any hit with t < max_t; stops at the first occluder
__device__ __forceinline__ bool occluded(const SceneView& s, V3 o, V3 d, float max_t) {
  int i = 0;
  for (int k = 0; k < s.n_tri; ++k, ++i)
    if (triangle_t(s.tbl + i * kTblW, o, d) < max_t) return true;
  for (int k = 0; k < s.n_sph; ++k, ++i)
    if (sphere_t(s.tbl + i * kTblW, o, d) < max_t) return true;
  for (int k = 0; k < s.n_pl; ++k, ++i)
    if (plane_t(s.tbl + i * kTblW, o, d) < max_t) return true;
  if (s.n_box > 0) {
    V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
    for (int k = 0; k < s.n_box; ++k, ++i)
      if (box_t(s.tbl + i * kTblW, o, inv) < max_t) return true;
  }
  return false;
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
  if (occluded(s, precise, L, max_t)) return v3(0.f, 0.f, 0.f);
  V3 Lh = normalize(L);
  V3 H = normalize(Lh + normalize(-d));
  float ndl = fmaxf(0.f, dot(n, Lh));
  float vdn = fmaxf(0.f, dot(H, n));
  float sp = vdn > 0.f ? powf(vdn, m.shine) : (m.shine == 0.f ? 1.f : 0.f);
  return (lcol * m.diff * ndl) * m.kd + (lcol * m.spec * sp) * (m.ks * 0.4f);
}

__device__ __forceinline__ V3 direct_light(const SceneView& s, V3 hp, V3 precise, V3 n, V3 d,
                           const Mat& m, float max_t, bool soft_grid) {
  V3 col = v3(0.f, 0.f, 0.f);
  for (int li = 0; li < s.n_lights; ++li) {
    V3 lpos = load3(s.lt + 6 * li);
    V3 lcol = load3(s.lt + 6 * li + 3);
    if (soft_grid) {
      // 4x4 grid of light positions, each 1/16 of the color
      // (main.cpp:601-618): spacing 0.125, start at pos - 0.25
      V3 c16 = lcol * (1.f / 16.f);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
          V3 pos = lpos + v3(-0.25f + 0.125f * j, -0.25f + 0.125f * i, 0.f);
          col = col + light_sample(s, pos, c16, hp, precise, n, d, m, max_t);
        }
    } else {
      col = col + light_sample(s, lpos, lcol, hp, precise, n, d, m, max_t);
    }
  }
  return col;
}

// ---------------------------------------------------------------------------
// the tree walk

struct Entry {
  V3 o, d, w;
  float ior;
  int depth;
};

// Pending refraction children. Entries hold strictly increasing depths in
// 2..MAXD, so CAP = MAXD-1 suffices. e[0] is the top: push and pop shift
// the whole array by one, so every index is a compile-time constant and the
// array stays in registers (a dynamic index would put it in local memory).
template <int CAP>
struct Stack {
  Entry e[CAP];
  int size = 0;
  __device__ __forceinline__ void push(const Entry& x) {
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
  }
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
  int soft_grid;
};

// The minimum of 4 blocks per SM caps a thread at 128 registers; with it
// ptxas keeps the depth-4 instantiation free of spills and stack (without
// it, 96 registers and 120 bytes of spill stores on sm_90a, nvcc 12.8).
template <int MAXD>
__global__ void __launch_bounds__(kThreads, 4) whitted_kernel(Params P) {
  extern __shared__ float smem[];
  const int n = P.n_tri + P.n_sph + P.n_pl + P.n_box;
  const int n_lt = 6 * (P.n_lights > 1 ? P.n_lights : 1);
  float* s_tbl = smem;
  float* s_lt = smem + n * kTblW;
  for (int k = threadIdx.x; k < n * kTblW; k += blockDim.x) s_tbl[k] = P.tbl[k];
  for (int k = threadIdx.x; k < n_lt; k += blockDim.x) s_lt[k] = P.lt[k];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P.n_rays) return;

  SceneView s{s_tbl, s_lt, load3(P.bg), P.n_tri, P.n_sph, P.n_pl, P.n_box,
              P.n_lights};
  const float max_t = P.shadow_unbounded ? kBig : 1.f;
  const bool secondary = P.has_refl || P.has_refr;

  V3 o = load3(P.ray_o + 3 * r);
  V3 d = load3(P.ray_d + 3 * r);
  V3 w = v3(1.f, 1.f, 1.f);
  float ior = 1.f;
  int depth = 1;
  V3 acc = v3(0.f, 0.f, 0.f);
  Stack<(MAXD > 1 ? MAXD - 1 : 1)> stack;

  while (true) {
    bool descend = false;
    float t;
    const int id = closest(s, o, d, t);
    if (id < 0) {
      acc = acc + w * s.bg;
    } else {
      const float* p = s_tbl + id * kTblW;
      const V3 hp = o + d * t;
      V3 nrm;
      if (id < P.n_tri) {
        nrm = load3(p + 9);
      } else if (id < P.n_tri + P.n_sph) {
        nrm = normalize(hp - load3(p));
      } else if (id < P.n_tri + P.n_sph + P.n_pl) {
        nrm = load3(p);
      } else {
        nrm = box_normal(p, o, d);
      }
      nrm = normalize(nrm);
      const V3 precise = hp + nrm * kEps;
      Mat m{load3(p + 12), load3(p + 15), p[18], p[19], p[20], p[21], p[22]};
      V3 local = direct_light(s, hp, precise, nrm, d, m, max_t, P.soft_grid);

      const bool leaf = depth >= MAXD;
      if (leaf || !secondary) {
        // depth cap clamps local (main.cpp:632-634)
        acc = acc + w * (leaf ? clamp01(local) : local);
      } else {
        acc = acc + w * local;
        // flipped normal for the secondary rays (main.cpp:639-643)
        const bool inside = dot(d, nrm) > 0.f;
        const V3 nf = inside ? -nrm : nrm;
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
                             depth + 1});
          }
        }
        if (P.has_refl && m.ks > 0.f) {
          // reflection child continues inline (main.cpp:646-667)
          d = normalize(d - nf * (2.f * dot(d, nf)));
          o = precise;
          w = w * (m.spec * kr);
          depth += 1;
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
    depth = e.depth;
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
// contiguous f32: ray_o, ray_d, out [n_rays*3]; tbl [n*23]; lt
// [max(1,n_lights)*6]; bg [3]. Launches on `stream` on the caller's current
// device (the caller selects it), does not synchronise, and returns the
// cudaError_t of the launch (0 = success).
extern "C" int whitted_megakernel_launch(
    void* stream, const float* ray_o, const float* ray_d,
    float* out, int n_rays, const float* tbl, const float* lt,
    const float* bg, int n_tri, int n_sph, int n_pl, int n_box, int n_lights,
    int has_refl, int has_refr, int max_depth, int fresnel_mode,
    int refraction_mode, int shadow_unbounded, int soft_grid) {
  if (n_rays <= 0) return 0;
  Params P{ray_o, ray_d, out, n_rays, tbl, lt, bg,
           n_tri, n_sph, n_pl, n_box, n_lights,
           has_refl, has_refr, fresnel_mode, refraction_mode,
           shadow_unbounded, soft_grid};
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
