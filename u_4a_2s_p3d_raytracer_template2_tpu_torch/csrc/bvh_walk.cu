// BVH walk for Hopper (sm_90a): closest hit, any hit, and any hit for L
// segments that share an origin, one thread per ray over one SAH tree of
// every bounded primitive (accel/packets.py builds the tables).
//
// Replaces the packet-BVH TPU kernels of the JAX package
//   u_4a_2s_p3d_raytracer_template2_tpu/accel/packets.py
//     K5a _make_closest_kernel      (pallas_call at :770, _walk_closest)
//     K5c _make_flat_closest_kernel (pallas_call at :843, _walk_closest_flat)
//         -> bvh_closest_launch: on a GPU a per-thread stack costs nothing
//            the flat unroll over <= 16 leaves would save, so both are one
//            walk;
//     K5b _make_any_kernel          (pallas_call at :813, _walk_any)
//         -> bvh_any_launch with one segment set;
//     K5d _make_flat_any_multi_kernel (pallas_call at :729, _walk_any_multi)
//         -> bvh_any_launch with L segment sets: one launch answers L sets
//            that share their origins, each thread walking once per set;
//            equal to L one-set launches.
// Their plain version is accel/packets.py's level-by-level walk over the
// same tables.
//
// What bounds it: per ray 24 B in and 8 B (closest) or 1 B (any) out, and
// tables of tens to hundreds of KB that stay in L2; the work is the node
// slab tests and primitive tests the walk cannot prune, and it is per-ray
// control flow with data-dependent depth. So:
//   * one thread per ray; a near-first descent with a per-thread stack of
//     (node, entry t); a closest-hit child is pruned when its entry is
//     greater than the best t (not >=, so an exact tie still reaches the
//     tie rule), an any-hit child when its entry is >= max_t;
//   * nodes (32 B) and primitive rows (64 B) read as float4 through the
//     read-only cache; no shared memory;
//   * the primitive tests are the brute-force formulas of ops/intersect.py
//     (direct (o-c) sphere form, Moller-Trumbore with |det| > eps and
//     t > eps, shared with brute_intersect.cu in prim_tests.cuh; slab
//     boxes, planes), and ties resolve as brute force does:
//     the smallest t, then type order triangle, sphere, plane, box, then the
//     lowest object id; planes, which have no box, are tested first, beside
//     the tree;
//   * 1/d uses the safe inverse (+-1e30 where |d| < 1e-30), since inactive
//     sweep slots trace axis-parallel rays;
//   * the host checks that the tree's depth fits kStack
//     (accel/packets.STACK_DEPTH).
// With a non-null counts [R, 5] (node box tests, then triangle, sphere,
// plane and box tests) each thread records its walk's work, summed over its
// segment sets; the main path passes null and runs the instantiation
// without counters.
// All math is f32 with IEEE division and square root, built without
// multiply-add contraction (kernels/build.NO_CONTRACTION).

#include <cuda_runtime.h>
#include <stdint.h>

#include "prim_tests.cuh"

namespace {

constexpr int kStack = 64;      // accel/packets.STACK_DEPTH
constexpr int kThreads = 128;

// type codes (core/constants.py)
constexpr int kPlane = 0;
constexpr int kTri = 1;
constexpr int kSph = 2;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float a;  // d.d
};

struct Work {
  int nodes, tris, sphs, planes, boxes;
};

__device__ __forceinline__ float safe_inv(float c) {
  if (fabsf(c) < 1e-30f) return c < 0.f ? -1e30f : 1e30f;
  return 1.f / c;
}

__device__ __forceinline__ Ray make_ray(const float* o, const float* d) {
  Ray r;
  r.ox = o[0]; r.oy = o[1]; r.oz = o[2];
  r.dx = d[0]; r.dy = d[1]; r.dz = d[2];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  r.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  return r;
}

// ops/intersect._plane_t_one: p = (normal, d)
__device__ __forceinline__ float plane_t(float4 p, const Ray& r) {
  float denom = r.dx * p.x + r.dy * p.y + r.dz * p.z;
  if (!(fabsf(denom) > kEps)) return kBig;
  float t = -(r.ox * p.x + r.oy * p.y + r.oz * p.z + p.w) / denom;
  return t > 0.f ? t : kBig;
}

__device__ __forceinline__ void slab_axis(float lo_b, float hi_b, float o,
                                          float inv, float& tmin,
                                          float& tmax) {
  float lo = (lo_b - o) * inv;
  float hi = (hi_b - o) * inv;
  bool pos = inv >= 0.f;
  tmin = pos ? lo : hi;
  tmax = pos ? hi : lo;
}

// ops/intersect._box_t_one: rows (min, max)
__device__ __forceinline__ float box_t(float4 p0, float4 p1, const Ray& r) {
  float a0, b0, a1, b1, a2, b2;
  slab_axis(p0.x, p0.w, r.ox, r.ix, a0, b0);
  slab_axis(p0.y, p1.x, r.oy, r.iy, a1, b1);
  slab_axis(p0.z, p1.y, r.oz, r.iz, a2, b2);
  float t_in = fmaxf(fmaxf(a0, a1), a2);
  float t_out = fminf(fminf(b0, b1), b2);
  if (!(t_in < t_out && t_out > kEps)) return kBig;
  return t_in > kEps ? t_in : t_out;
}

// Node box: entry t, and whether the box meets the ray's t >= 0 half.
__device__ __forceinline__ bool node_slab(const float4* __restrict__ nodes,
                                          int n, const Ray& r, float& tn) {
  float4 a = __ldg(nodes + 2 * n);
  float4 b = __ldg(nodes + 2 * n + 1);
  float lx = (a.x - r.ox) * r.ix, hx = (a.w - r.ox) * r.ix;
  float ly = (a.y - r.oy) * r.iy, hy = (b.x - r.oy) * r.iy;
  float lz = (a.z - r.oz) * r.iz, hz = (b.y - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  float tf = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
  return tn <= tf && tf >= 0.f;
}

// (first child or row, leaf row count) of node n
__device__ __forceinline__ int2 node_meta(const float4* __restrict__ nodes,
                                          int n) {
  float4 b = __ldg(nodes + 2 * n + 1);
  return make_int2(__float_as_int(b.z), __float_as_int(b.w));
}

// Test primitive row i; returns its t (kBig on a miss) and sets its tie
// rank and object id.
template <bool COUNT>
__device__ __forceinline__ float row_t(const float4* __restrict__ rows, int i,
                                       const Ray& r, int& rank, int& id,
                                       Work& w) {
  const float4* p = rows + 4 * i;
  float4 m = __ldg(p + 3);
  int type = __float_as_int(m.x);
  id = __float_as_int(m.y);
  float4 p0 = __ldg(p);
  if (type == kSph) {
    rank = 1;
    if (COUNT) ++w.sphs;
    return sphere_t(p0, r);
  }
  float4 p1 = __ldg(p + 1);
  if (type == kTri) {
    rank = 0;
    if (COUNT) ++w.tris;
    return triangle_t(p0, p1, __ldg(p + 2), r);
  }
  if (type == kPlane) {
    rank = 2;
    if (COUNT) ++w.planes;
    return plane_t(p0, r);
  }
  rank = 3;
  if (COUNT) ++w.boxes;
  return box_t(p0, p1, r);
}

struct Tables {
  const float4* nodes;
  const float4* rows;
  const float4* planes;
  int n_planes;
};

template <bool COUNT>
__device__ void walk_closest(const Tables& T, const Ray& r, float& bt,
                             int& bid, Work& w) {
  int brank = 4;
  bid = 0x7fffffff;
  bt = kBig;
  auto offer = [&](float t, int rank, int id) {
    if (t < kBig && (t < bt || (t == bt && (rank < brank ||
                                            (rank == brank && id < bid))))) {
      bt = t;
      brank = rank;
      bid = id;
    }
  };
  int rank, id;
  for (int j = 0; j < T.n_planes; ++j) {
    float t = row_t<COUNT>(T.planes, j, r, rank, id, w);
    offer(t, rank, id);
  }

  int stack_n[kStack];
  float stack_t[kStack];
  int sp = 0;
  float tn;
  if (COUNT) ++w.nodes;
  bool go = node_slab(T.nodes, 0, r, tn) && tn <= bt;
  int node = 0;
  while (go) {
    int2 m = node_meta(T.nodes, node);
    if (m.y > 0) {
      for (int i = m.x; i < m.x + m.y; ++i) {
        float t = row_t<COUNT>(T.rows, i, r, rank, id, w);
        offer(t, rank, id);
      }
    } else {
      float tl, tr;
      if (COUNT) w.nodes += 2;
      bool hl = node_slab(T.nodes, m.x, r, tl) && tl <= bt;
      bool hr = node_slab(T.nodes, m.x + 1, r, tr) && tr <= bt;
      if (hl && hr) {
        bool left_first = tl <= tr;
        stack_n[sp] = left_first ? m.x + 1 : m.x;
        stack_t[sp] = left_first ? tr : tl;
        ++sp;
        node = left_first ? m.x : m.x + 1;
        continue;
      }
      if (hl || hr) {
        node = hl ? m.x : m.x + 1;
        continue;
      }
    }
    go = false;
    while (sp > 0) {
      --sp;
      if (stack_t[sp] <= bt) {
        node = stack_n[sp];
        go = true;
        break;
      }
    }
  }
}

template <bool COUNT>
__device__ bool walk_any(const Tables& T, const Ray& r, float max_t,
                         Work& w) {
  int rank, id;
  for (int j = 0; j < T.n_planes; ++j)
    if (row_t<COUNT>(T.planes, j, r, rank, id, w) < max_t) return true;

  int stack_n[kStack];
  int sp = 0;
  float tn;
  if (COUNT) ++w.nodes;
  if (!(node_slab(T.nodes, 0, r, tn) && tn < max_t)) return false;
  int node = 0;
  while (true) {
    int2 m = node_meta(T.nodes, node);
    if (m.y > 0) {
      for (int i = m.x; i < m.x + m.y; ++i)
        if (row_t<COUNT>(T.rows, i, r, rank, id, w) < max_t) return true;
    } else {
      float tl, tr;
      if (COUNT) w.nodes += 2;
      bool hl = node_slab(T.nodes, m.x, r, tl) && tl < max_t;
      bool hr = node_slab(T.nodes, m.x + 1, r, tr) && tr < max_t;
      if (hl && hr) {
        bool left_first = tl <= tr;
        stack_n[sp++] = left_first ? m.x + 1 : m.x;
        node = left_first ? m.x : m.x + 1;
        continue;
      }
      if (hl || hr) {
        node = hl ? m.x : m.x + 1;
        continue;
      }
    }
    if (sp == 0) return false;
    node = stack_n[--sp];
  }
}

template <bool COUNT>
__device__ __forceinline__ void store_work(int* counts, int r,
                                           const Work& w) {
  if (COUNT) {
    int* c = counts + 5 * r;
    c[0] = w.nodes;
    c[1] = w.tris;
    c[2] = w.sphs;
    c[3] = w.planes;
    c[4] = w.boxes;
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               int n_rays, Tables T, float* __restrict__ out_t,
               int* __restrict__ out_id, int* __restrict__ counts) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  Ray ray = make_ray(o + 3 * r, d + 3 * r);
  Work w{0, 0, 0, 0, 0};
  float bt;
  int bid;
  walk_closest<COUNT>(T, ray, bt, bid, w);
  out_t[r] = bt;
  out_id[r] = bt < kBig ? bid : -1;
  store_work<COUNT>(counts, r, w);
}

// L segment sets [L, R, 3] from one origin set [R, 3]; L = 1 is bvh_any.
template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ o, const float* __restrict__ dirs,
           int n_sets, int n_rays, float max_t,
           const uint8_t* __restrict__ dead, Tables T,
           uint8_t* __restrict__ out, int* __restrict__ counts) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  Work w{0, 0, 0, 0, 0};
  for (int l = 0; l < n_sets; ++l) {
    size_t k = (size_t)l * n_rays + r;
    bool occ = true;  // dead lanes report occluded without a walk
    if (!(dead && dead[k]))
      occ = walk_any<COUNT>(T, make_ray(o + 3 * r, dirs + 3 * k), max_t, w);
    out[k] = occ ? 1 : 0;
  }
  store_work<COUNT>(counts, r, w);
}

}  // namespace

extern "C" int bvh_closest_launch(void* stream, const float* o,
                                  const float* d, int n_rays,
                                  const float* nodes, const float* rows,
                                  const float* planes, int n_planes,
                                  float* out_t, int* out_id, int* counts) {
  if (n_rays <= 0) return 0;
  if (n_planes < 0) return (int)cudaErrorInvalidValue;
  Tables T{(const float4*)nodes, (const float4*)rows, (const float4*)planes,
           n_planes};
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    closest_kernel<true><<<blocks, kThreads, 0, s>>>(o, d, n_rays, T, out_t,
                                                     out_id, counts);
  else
    closest_kernel<false><<<blocks, kThreads, 0, s>>>(o, d, n_rays, T, out_t,
                                                      out_id, counts);
  return (int)cudaGetLastError();
}

extern "C" int bvh_any_launch(void* stream, const float* o,
                              const float* dirs, int n_sets, int n_rays,
                              float max_t, const uint8_t* dead,
                              const float* nodes, const float* rows,
                              const float* planes, int n_planes,
                              uint8_t* out, int* counts) {
  if (n_rays <= 0 || n_sets <= 0) return 0;
  if (n_planes < 0) return (int)cudaErrorInvalidValue;
  Tables T{(const float4*)nodes, (const float4*)rows, (const float4*)planes,
           n_planes};
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    any_kernel<true><<<blocks, kThreads, 0, s>>>(o, dirs, n_sets, n_rays,
                                                 max_t, dead, T, out, counts);
  else
    any_kernel<false><<<blocks, kThreads, 0, s>>>(o, dirs, n_sets, n_rays,
                                                  max_t, dead, T, out, counts);
  return (int)cudaGetLastError();
}
