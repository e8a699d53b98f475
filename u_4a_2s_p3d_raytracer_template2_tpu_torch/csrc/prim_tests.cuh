// Sphere and triangle tests shared by the BVH walk (bvh_walk.cu), the
// brute-force kernels (brute_intersect.cu) and the Whitted megakernel
// (whitted_megakernel.cu): the formulas of
// ops/intersect.py operation for operation, so that the kernels, built
// without multiply-add contraction (kernels/build.NO_CONTRACTION), answer
// as the plain version does, bit for bit. A ray type R has the origin
// (ox, oy, oz), the direction (dx, dy, dz) and a = d.d; the gated forms
// below also read a4 = 4a.
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

// The end of ops/intersect._sphere_t_one from its discriminant delta, its
// b and the ray's a: the smaller root >= 0, else the larger, or kBig.
__device__ __forceinline__ float sphere_roots(float b, float delta, float a) {
  if (!(delta >= 0.f)) return kBig;
  float sq = delta > 0.f ? sqrtf(delta) : 0.f;
  float t0 = (-b - sq) / (2.f * a);
  float t1 = (-b + sq) / (2.f * a);
  float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
  float t = lo < 0.f ? hi : lo;
  return t >= 0.f ? t : kBig;
}

// ops/intersect._sphere_t_one: p = (center, radius), the direct (o-c) form
template <class R>
__device__ __forceinline__ float sphere_t(float4 p, const R& r, int& stage) {
  float lx = r.ox - p.x, ly = r.oy - p.y, lz = r.oz - p.z;
  float b = 2.f * (r.dx * lx + r.dy * ly + r.dz * lz);
  float cc = lx * lx + ly * ly + lz * lz - p.w * p.w;
  float delta = b * b - 4.f * r.a * cc;
  stage = delta >= 0.f ? kSphRoots : kSphMiss;
  return sphere_roots(b, delta, r.a);
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

// The sphere test split at its gate, for callers that run the gates of
// several tests as one straight run and branch once. b, and the two terms
// of the discriminant bb - ac, computed as the plain version computes them.
// The gate is bb >= ac: delta = fl(bb - ac) >= 0 implies it (an exact
// difference of floats is 0 or at least 2^-149 in magnitude; inf - inf is
// NaN and fails delta >= 0, so the gate only passes more), and the tests
// that pass it end in sphere_roots on delta = bb - ac, so every answer is
// sphere_t's, bit for bit.
struct Gate {
  float b, bb, ac;
  __device__ __forceinline__ bool open() const { return bb >= ac; }
  // the rest of the test, for a gate that is open: t or kBig
  template <class R>
  __device__ __forceinline__ float t(const R& r) const {
    return sphere_roots(b, bb - ac, r.a);
  }
};

// rr = p.w * p.w, which a caller may compute once a row
template <class R>
__device__ __forceinline__ Gate sphere_gate(float4 p, float rr, const R& r) {
  const float lx = r.ox - p.x, ly = r.oy - p.y, lz = r.oz - p.z;
  Gate g;
  g.b = 2.f * (r.dx * lx + r.dy * ly + r.dz * lz);
  const float cc = lx * lx + ly * ly + lz * lz - rr;
  g.bb = g.b * g.b;
  g.ac = r.a4 * cc;
  return g;
}

// The triangle test (triangle_t) up to its u gate with no branch: f = 1/det
// is taken whatever det is, and read only where the det gate passed, so an
// open gate's values are triangle_t's.
struct TriGate {
  float det, f, u, sx, sy, sz;
  __device__ __forceinline__ bool open() const {
    return fabsf(det) > kEps && u >= 0.f && u <= 1.f;
  }
  // the rest of triangle_t, for a gate that is open: t or kBig
  template <class R>
  __device__ __forceinline__ float t(float4 p0, float4 p1, float4 p2,
                                     const R& r) const {
    const float e1x = p0.w, e1y = p1.x, e1z = p1.y;
    const float e2x = p1.z, e2y = p1.w, e2z = p2.x;
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
    if (!(v >= 0.f && u + v <= 1.f)) return kBig;
    const float tt = f * (e2x * qx + e2y * qy + e2z * qz);
    return tt > kEps ? tt : kBig;
  }
};

template <class R>
__device__ __forceinline__ TriGate triangle_gate(float4 p0, float4 p1,
                                                 float4 p2, const R& r) {
  const float e1x = p0.w, e1y = p1.x, e1z = p1.y;
  const float e2x = p1.z, e2y = p1.w, e2z = p2.x;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  TriGate g;
  g.det = e1x * hx + e1y * hy + e1z * hz;
  g.f = 1.f / g.det;
  g.sx = r.ox - p0.x;
  g.sy = r.oy - p0.y;
  g.sz = r.oz - p0.z;
  g.u = g.f * (g.sx * hx + g.sy * hy + g.sz * hz);
  return g;
}
