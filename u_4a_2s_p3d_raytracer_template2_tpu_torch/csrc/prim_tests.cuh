// Sphere and triangle tests shared by the BVH walk (bvh_walk.cu) and the
// brute-force kernels (brute_intersect.cu): the formulas of
// ops/intersect.py operation for operation, so that both kernels, built
// without multiply-add contraction (kernels/build.NO_CONTRACTION), answer
// as the plain version does, bit for bit. A ray type R has the origin
// (ox, oy, oz), the direction (dx, dy, dz) and a = d.d.
//
// Each test returns its t, kBig on a miss, and may report where it ended
// (`stage`) for a kernel's work counters; a caller that ignores the stage
// compiles to the same code as one without it.
#pragma once

constexpr float kEps = 1e-3f;   // core/constants.EPSILON
constexpr float kBig = 1e30f;   // core/constants.BIG

// where a sphere test ended: at a negative discriminant, or with its roots
constexpr int kSphMiss = 0, kSphRoots = 1, kSphStages = 2;
// where a triangle test ended: at the det gate, the u gate, the v gate, or
// with its t
constexpr int kTriDet = 0, kTriU = 1, kTriV = 2, kTriT = 3, kTriStages = 4;

// ops/intersect._sphere_t_one: p = (center, radius), the direct (o-c) form
template <class R>
__device__ __forceinline__ float sphere_t(float4 p, const R& r, int& stage) {
  float lx = r.ox - p.x, ly = r.oy - p.y, lz = r.oz - p.z;
  float b = 2.f * (r.dx * lx + r.dy * ly + r.dz * lz);
  float cc = lx * lx + ly * ly + lz * lz - p.w * p.w;
  float delta = b * b - 4.f * r.a * cc;
  stage = kSphMiss;
  if (!(delta >= 0.f)) return kBig;
  stage = kSphRoots;
  float sq = delta > 0.f ? sqrtf(delta) : 0.f;
  float t0 = (-b - sq) / (2.f * r.a);
  float t1 = (-b + sq) / (2.f * r.a);
  float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
  float t = lo < 0.f ? hi : lo;
  return t >= 0.f ? t : kBig;
}

template <class R>
__device__ __forceinline__ float sphere_t(float4 p, const R& r) {
  int stage;
  return sphere_t(p, r, stage);
}

// ops/intersect._triangle_t_one (Moller-Trumbore): v0 in p0.xyz, e1 in
// (p0.w, p1.x, p1.y), e2 in (p1.z, p1.w, p2.x)
template <class R>
__device__ __forceinline__ float triangle_t(float4 p0, float4 p1, float4 p2,
                                            const R& r, int& stage) {
  float v0x = p0.x, v0y = p0.y, v0z = p0.z;
  float e1x = p0.w, e1y = p1.x, e1z = p1.y;
  float e2x = p1.z, e2y = p1.w, e2z = p2.x;
  float hx = r.dy * e2z - r.dz * e2y;
  float hy = r.dz * e2x - r.dx * e2z;
  float hz = r.dx * e2y - r.dy * e2x;
  float det = e1x * hx + e1y * hy + e1z * hz;
  stage = kTriDet;
  if (!(fabsf(det) > kEps)) return kBig;
  float f = 1.f / det;
  float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  float u = f * (sx * hx + sy * hy + sz * hz);
  stage = kTriU;
  if (!(u >= 0.f && u <= 1.f)) return kBig;
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  stage = kTriV;
  if (!(v >= 0.f && u + v <= 1.f)) return kBig;
  stage = kTriT;
  float t = f * (e2x * qx + e2y * qy + e2z * qz);
  return t > kEps ? t : kBig;
}

template <class R>
__device__ __forceinline__ float triangle_t(float4 p0, float4 p1, float4 p2,
                                            const R& r) {
  int stage;
  return triangle_t(p0, p1, p2, r, stage);
}
