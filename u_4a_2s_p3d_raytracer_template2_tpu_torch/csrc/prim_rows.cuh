// One primitive row of a walk's table, shared by the 4-wide BVH walk
// (bvh_walk.cu) and the reference's per-ray traversals (perray_traverse.cu):
// the ray as the walks carry it (safe inverse and d.d), the plane and slab
// box tests, and row_t, which tests one row of 4 float4 (the 12 parameters
// of prims.params, then the type code and object id as int32 bits: the
// layout of accel/packets.py's rows and kernels.perray_rows' table), so
// that every walk tests a primitive with the same f32 operations, which
// are ops/intersect.per_ray_t's one for one. Work counts a walk's tests
// for its counted instantiation (kernels.WORK_COUNTS).
#pragma once

#include "prim_tests.cuh"

// type codes (core/constants.py)
constexpr int kPlane = 0;
constexpr int kTri = 1;
constexpr int kSph = 2;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float a;  // d.d
};

struct Work {
  int nodes, tri[kTriStages], sph[kSphStages], planes, boxes;
};
constexpr int kWorkCounts = 3 + kTriStages + kSphStages;

template <int N>
__device__ __forceinline__ void tally(int (&c)[N], int stage) {
#pragma unroll
  for (int k = 0; k < N; ++k) c[k] += stage == k;
}

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

// Test primitive row i, whose type and id (its fourth float4) and first
// float4 the caller has read: returns its t (kBig on a miss) and sets its
// tie rank and object id.
template <bool COUNT>
__device__ __forceinline__ float row_t(const float4* __restrict__ rows, int i,
                                       float4 m, float4 p0, const Ray& r,
                                       int& rank, int& id, Work& w) {
  const float4* p = rows + 4 * i;
  int type = __float_as_int(m.x);
  id = __float_as_int(m.y);
  int stage;
  if (type == kSph) {
    rank = 1;
    const float t = sphere_t(p0, r, stage);
    if (COUNT) tally(w.sph, stage);
    return t;
  }
  float4 p1 = __ldg(p + 1);
  if (type == kTri) {
    rank = 0;
    const float t = triangle_t(p0, p1, __ldg(p + 2), r, stage);
    if (COUNT) tally(w.tri, stage);
    return t;
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

template <bool COUNT>
__device__ __forceinline__ void add_work(int* counts, int r, const Work& w) {
  if (COUNT) {
    int* c = counts + kWorkCounts * r;
    atomicAdd(c, w.nodes);
#pragma unroll
    for (int k = 0; k < kTriStages; ++k) atomicAdd(c + 1 + k, w.tri[k]);
#pragma unroll
    for (int k = 0; k < kSphStages; ++k)
      atomicAdd(c + 1 + kTriStages + k, w.sph[k]);
    atomicAdd(c + 1 + kTriStages + kSphStages, w.planes);
    atomicAdd(c + 2 + kTriStages + kSphStages, w.boxes);
  }
}
