// Path-tracer megakernel for Hopper (sm_90a): the whole bounce loop of the
// GLSL Monte Carlo path tracer (P3D_RT.glsl:236-282 rayColor) for every path
// in one kernel.
//
// Replaces the TPU kernel of the JAX package
//   u_4a_2s_p3d_raytracer_template2_tpu/models/pt_megakernel.py
//     _build_kernel (pallas_call at :535, in _trace_fn_cached)
// and computes the function of models/pathtracer.ray_color_presampled, its
// plain version: the same closest-hit and shadow tests, direct light and
// scatter, fed the same pre-drawn uniforms [B, 11, R].
//
// What bounds it: a frame moves 28 B of ray per path in, 44 B of uniforms
// per live bounce and 12 B of color out, tens of MB at 512x512, a few
// microseconds of the card's memory. The work is arithmetic: every live
// bounce tests every sphere and triangle for the closest hit, then once more
// per light for the shadow feeler, and the bounce count varies per path.
// Most of that work is sphere tests that miss: glsl_world's closest hit
// tests 102 spheres, of which a ray hits one. The design follows from that:
//   * one thread per path, running its own bounce loop until the path dies
//     (sky miss, absorption, Russian roulette) or the bounces run out; the
//     ragged edge is masked with r < R, with no pad rays;
//   * the world arrives as operand tables (models/pt_megakernel.pt_tables):
//     [N*24] sphere then triangle rows, each its geometry padded to 12
//     floats and its material, and [L*6] lights, copied into shared memory
//     at block start; every thread of a warp reads the same primitive at
//     the same time, so reads are broadcasts, 16 bytes at a time (ld4), and
//     one build serves every world within the ceilings;
//   * a static sphere (zero time span) skips the centre's lerp and its
//     division; the branch is uniform across a warp;
//   * the sphere test is split before its square root: a walk runs the
//     gates of kGroup spheres (the c>0 && b>0 reject and the discriminant)
//     as one straight run of independent chains and branches once, and
//     only an open gate takes its square root; the closest hit folds the
//     group in table order with strict <, so it keeps the first minimum;
//   * the closest hit and the shadow feelers share that walk; a feeler
//     stops at its first occluder;
//   * uniforms are read at [(b*11 + k)*R + r]: consecutive threads read
//     consecutive words.
// All math is f32 with IEEE division, square root, cbrtf, expf, sinf and
// cosf (no fast math). nvcc contracts multiply-adds (its default), as the
// path tracer's limits (chip_smoke.PT_LIMITS) were set for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-3f;   // common.glsl:2, also t_min
constexpr float kTMax = 1e4f;   // P3D_RT.glsl:243
constexpr float kBig = 1e30f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530718f;  // ops/sampling.TWO_PI
constexpr int kRowW = 24;            // floats a row (ROW_W)
constexpr int kGeomW = 12;           // the material's first float (GEOM_W)
constexpr int kNU = 11;
constexpr int kThreads = 128;
constexpr int kGroup = 4;            // spheres a step of a walk
constexpr int kMaxSpheres = 256;
constexpr int kMaxTris = 16;
constexpr int kMaxLights = 8;

// material types (models/pathtracer.MT_*); 2 is the dielectric
constexpr int kDiffuse = 0;
constexpr int kMetal = 1;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// The k-th 16 bytes of a table row: rows are kRowW floats, 16-byte
// aligned, three float4 of geometry, then the material.
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

// ops/sampling.unit_sphere_from_uniforms: cube-root radius, polar angle
__device__ __forceinline__ V3 unit_sphere(float u1, float u2, float u3) {
  const float x = u1 * 2.f - 1.f;
  const float phi = u2 * kTwoPi;
  const float r = cbrtf(u3);
  const float s = sqrtf(fmaxf(1.f - x * x, 0.f));
  return v3(r * (s * sinf(phi)), r * (s * cosf(phi)), r * x);
}

// ---------------------------------------------------------------------------
// primitive tests over the shared-memory rows; kBig when not hit in
// (t_min, t_max) (models/pathtracer._hit_spheres, _hit_triangles)

// Sphere row: c0(3) c1(3) r t0 t1, then 3 pad floats, as (c0, c1.x),
// (c1.yz, r, t0), (t1, pad). The center is lerped by the ray's time; a zero
// time span means frac 0, and then the center is c0: c0 + (c1 - c0) * 0
// equals c0 (chip_faults.py's PT_DESIGN holds a kernel that lerps every
// sphere to this one, bit for bit), so a static sphere skips the lerp and
// its division. The branch is the same in every lane of a warp: they test
// the same row.
__device__ __forceinline__ V3 sphere_center(const float* p, float time) {
  const float4 p0 = ld4(p, 0), p1 = ld4(p, 1);
  const float span = ld4(p, 2).x - p1.w;
  const V3 c0 = v3(p0.x, p0.y, p0.z);
  if (span == 0.f) return c0;
  const float frac = (time - p1.w) / span;
  return c0 + (v3(p0.w, p1.x, p1.y) - c0) * frac;
}

// The sphere test split before its square root, for walks that run the
// gates of several rows as one straight run and branch once: the GLSL
// half-b quadratic with the c>0 && b>0 reject; t = t0 < 0 ? t1 : t0.
struct SphereGate {
  float b, c, disc;
  __device__ __forceinline__ bool open() const {
    return !(c > 0.f && b > 0.f) && disc >= 0.f;
  }
  // the rest of the test, for a gate that is open: t or kBig
  __device__ __forceinline__ float t(float t_max) const {
    const float sq = sqrtf(disc);
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    const float t = t0 < 0.f ? t1 : t0;
    return (t > kEps && t < t_max) ? t : kBig;
  }
};

__device__ __forceinline__ SphereGate sphere_gate(const float* p, V3 o, V3 d,
                                                  float time) {
  const V3 L = o - sphere_center(p, time);
  const float r = ld4(p, 1).z;
  SphereGate g;
  g.b = dot(L, d);
  g.c = dot(L, L) - r * r;
  g.disc = g.b * g.b - g.c;
  return g;
}

// Triangle row: v0(3) e1(3) e2(3), then 3 pad floats. Moller-Trumbore
// with a |det| > 1e-7 cutoff, u and v in [0,1] but no u+v <= 1 guard (the
// GLSL quirk).
__device__ __forceinline__ float triangle_t(const float* p, V3 o, V3 d, float t_max) {
  const float4 p0 = ld4(p, 0), p1 = ld4(p, 1), p2 = ld4(p, 2);
  const V3 e1 = v3(p0.w, p1.x, p1.y), e2 = v3(p1.z, p1.w, p2.x);
  const V3 h = cross(d, e2);
  const float det = dot(h, e1);
  if (!(fabsf(det) > 1e-7f)) return kBig;
  const float f = 1.f / det;
  const V3 s = o - v3(p0.x, p0.y, p0.z);
  const float u = f * dot(s, h);
  if (!(u >= 0.f && u <= 1.f)) return kBig;
  const V3 q = cross(s, e1);
  const float v = f * dot(d, q);
  if (!(v >= 0.f && v <= 1.f)) return kBig;
  const float t = f * dot(e2, q);
  return (t > kEps && t < t_max) ? t : kBig;
}

struct World {
  const float* rows;  // n_sph sphere rows, then n_tri triangle rows
  const float* lt;
  int n_sph, n_tri, n_lights;
};

// Visit the rows, spheres then triangles, with each test's t (kBig when
// not hit in (t_min, t_max)) until visit(row, t) returns true; returns
// whether it did. Spheres go kGroup rows a step: the group's gates, then
// one branch that finishes the open ones in table order. A closed gate's
// test is a miss, which neither walk below needs to see.
template <class Visit>
__device__ __forceinline__ bool walk(const World& w, V3 o, V3 d, float time,
                                     float t_max, Visit visit) {
  int i = 0;
  for (; i + kGroup <= w.n_sph; i += kGroup) {
    SphereGate g[kGroup];
    bool open = false;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      g[k] = sphere_gate(w.rows + (i + k) * kRowW, o, d, time);
      open |= g[k].open();
    }
    if (open) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (g[k].open() && visit(i + k, g[k].t(t_max))) return true;
    }
  }
  for (; i < w.n_sph; ++i) {
    const SphereGate g = sphere_gate(w.rows + i * kRowW, o, d, time);
    if (g.open() && visit(i, g.t(t_max))) return true;
  }
  for (; i < w.n_sph + w.n_tri; ++i)
    if (visit(i, triangle_t(w.rows + i * kRowW, o, d, t_max))) return true;
  return false;
}

// Closest hit: the first minimum among spheres, then a triangle only if
// strictly closer (hit_world's argmin and use_tri = tt < ts): a strict-<
// fold in table order. Returns the row or -1.
__device__ __forceinline__ int closest(const World& w, V3 o, V3 d, float time,
                                       float& t_best) {
  t_best = kBig;
  int best = -1;
  walk(w, o, d, time, kTMax, [&](int i, float t) {
    if (t < t_best) { t_best = t; best = i; }
    return false;
  });
  return best;
}

// any hit in (t_min, max_t); stops at the first occluder
__device__ __forceinline__ bool occluded(const World& w, V3 o, V3 d, float time,
                                         float max_t) {
  return walk(w, o, d, time, max_t, [](int, float t) { return t < kBig; });
}

// Direct light (P3D_RT.glsl:182-232, pathtracer.direct_lighting): per-type
// Blinn-Phong constants, diffuse kd=1 with spec 0.1 and shininess 10 (ks=0),
// metal spec=albedo and dielectric spec 0.004 with shininess 100 (kd=0).
// The feeler starts at point + 1e-3*n, n the geometric normal.
__device__ __forceinline__ V3 direct_light(const World& w, V3 point, V3 n, V3 d,
                                           float time, int mtype, V3 albedo,
                                           bool shadow_len1) {
  V3 out = v3(0.f, 0.f, 0.f);
  const V3 fo = point + n * kEps;
  for (int li = 0; li < w.n_lights; ++li) {
    const V3 lpos = load3(w.lt + 6 * li);
    const V3 lcol = load3(w.lt + 6 * li + 3);
    const V3 L = lpos - point;
    const float len = sqrtf(dot(L, L));
    const V3 ldir = len > 0.f ? v3(L.x / len, L.y / len, L.z / len)
                              : v3(0.f, 0.f, 0.f);
    const float ndl = dot(n, ldir);
    if (!(ndl > 0.f)) continue;
    if (occluded(w, fo, ldir, time, shadow_len1 ? 1.f : len)) continue;
    if (mtype == kDiffuse) {
      out = out + lcol * albedo * ndl;
    } else {
      const V3 H = normalize(ldir - d);
      const float nh = fmaxf(0.f, dot(n, H));
      const V3 spec = mtype == kMetal ? albedo : v3(0.004f, 0.004f, 0.004f);
      out = out + lcol * spec * powf(nh, 100.f);
    }
  }
  return out;
}

struct Params {
  const float* ray_o;
  const float* ray_d;
  const float* ray_t;
  const float* uni;
  float* out;
  int n_rays, n_bounces;
  const float* tbl;
  const float* lt;
  int n_sph, n_tri, n_lights;
  int russian_roulette;
  int shadow_len1;
};

__global__ void __launch_bounds__(kThreads) pt_kernel(Params P) {
  extern __shared__ float4 smem[];  // 16-byte aligned rows
  const int n_rows = P.n_sph + P.n_tri;
  const int n_lt = 6 * (P.n_lights > 1 ? P.n_lights : 1);
  float* s_rows = reinterpret_cast<float*>(smem);
  float* s_lt = s_rows + n_rows * kRowW;
  for (int k = threadIdx.x; k < n_rows * kRowW; k += blockDim.x) s_rows[k] = P.tbl[k];
  for (int k = threadIdx.x; k < n_lt; k += blockDim.x) s_lt[k] = P.lt[k];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P.n_rays) return;

  const World w{s_rows, s_lt, P.n_sph, P.n_tri, P.n_lights};
  const int R = P.n_rays;
  V3 o = load3(P.ray_o + 3 * r);
  V3 d = load3(P.ray_d + 3 * r);
  const float time = P.ray_t[r];
  V3 thr = v3(1.f, 1.f, 1.f);
  V3 col = v3(0.f, 0.f, 0.f);

  for (int b = 0; b < P.n_bounces; ++b) {
    const float* u = P.uni + (size_t)b * kNU * R + r;  // u[k * R] = row k
    float t;
    const int id = closest(w, o, d, time, t);
    if (id < 0) {
      // sky on miss (P3D_RT.glsl:274-279)
      const float tt = 0.8f * (d.y + 1.f);
      col = col + thr * v3((1.f - tt) + tt * 0.5f, (1.f - tt) + tt * 0.7f,
                           (1.f - tt) + tt * 1.f);
      break;
    }
    const float* p = w.rows + id * kRowW;
    const V3 point = o + d * t;
    V3 n;
    if (id < P.n_sph) {
      // shell orientation from the sign of the radius (common.glsl:460)
      n = normalize(point - sphere_center(p, time)) * (p[6] < 0.f ? -1.f : 1.f);
    } else {
      const float4 p0 = ld4(p, 0), p1 = ld4(p, 1), p2 = ld4(p, 2);
      n = normalize(cross(v3(p0.w, p1.x, p1.y), v3(p1.z, p1.w, p2.x)));
    }
    // mtype albedo(3) spec(3) rough ref_idx refract(3)
    const float* m = p + kGeomW;
    const int mtype = (int)m[0];
    const V3 albedo = load3(m + 1);

    col = col + thr * direct_light(w, point, n, d, time, mtype, albedo,
                                   P.shadow_len1 != 0);

    // scatter (common.glsl:216-324, pathtracer.scatter_presampled)
    V3 new_o, new_d, atten;
    if (mtype == kDiffuse) {
      const V3 s = unit_sphere(u[0], u[R], u[2 * R]);
      const float sn = fmaxf(sqrtf(dot(s, s)), 1e-12f);
      const V3 uv = v3(s.x / sn, s.y / sn, s.z / sn);
      const V3 s_point = point + n + uv;
      new_d = normalize(s_point - point);
      const V3 a = albedo * fmaxf(dot(new_d, n), 0.f);
      atten = v3(a.x / kPi, a.y / kPi, a.z / kPi);
      new_o = point + n * kEps;
    } else {
      const float rough = m[7];
      const float dn = dot(d, n);
      const V3 mirror = normalize(d - (2.f * dn) * n);
      if (mtype == kMetal) {
        // fuzzy mirror, direction NOT renormalized (common.glsl:229-240)
        new_d = mirror + rough * unit_sphere(u[3 * R], u[4 * R], u[5 * R]);
        new_o = point + n * kEps;
        atten = load3(m + 4);
      } else {
        // DIELECTRIC (common.glsl:241-322)
        const float ref_idx = m[8];
        const bool inside = dn > 0.f;
        const V3 outward = inside ? -n : n;
        const float ni_over_nt = inside ? ref_idx : 1.f / ref_idx;
        const float cosine = inside ? dn : -dn;
        const float eta_i = inside ? ref_idx : 1.f;
        const float eta_t = inside ? 1.f : ref_idx;
        float r0 = (eta_i - eta_t) / (eta_i + eta_t);
        r0 = r0 * r0;
        const float k = 1.f - ni_over_nt * ni_over_nt * (1.f - cosine * cosine);
        const float om = 1.f - cosine;
        const float om2 = om * om;
        const float reflect_prob = k < 0.f ? 1.f : r0 + (1.f - r0) * (om * (om2 * om2));
        // one sphere sample feeds both the fuzz and the rough blend
        const V3 sph4 = unit_sphere(u[7 * R], u[8 * R], u[9 * R]);
        if (u[6 * R] < reflect_prob) {
          // reflect branch: rec.normal for the direction, outward for the
          // origin offset (common.glsl:296)
          new_d = mirror + rough * sph4;
          new_o = point + outward * kEps;
          atten = albedo;
        } else {
          const float sqk = sqrtf(fmaxf(k, 0.f));
          V3 d_refr = normalize(ni_over_nt * d + (ni_over_nt * cosine - sqk) * outward);
          const V3 blend = normalize(outward + sph4);
          const float rr = rough * rough;
          new_d = d_refr * (1.f - rr) + blend * rr;
          new_o = point - outward * kEps;
          // Beer's law on the refracted branch only (common.glsl:314)
          const V3 rc = load3(m + 9);
          atten = albedo * v3(expf(rc.x * -t), expf(rc.y * -t), expf(rc.z * -t));
        }
      }
    }
    thr = thr * atten;
    o = new_o;
    d = new_d;

    if (P.russian_roulette) {  // P3D_RT.glsl:265-271
      const float pmax = fmaxf(thr.x, fmaxf(thr.y, thr.z));
      if (u[10 * R] > pmax) break;
      const float q = fmaxf(pmax, 1e-8f);
      thr = v3(thr.x / q, thr.y / q, thr.z / q);
    }
  }

  P.out[3 * r + 0] = col.x;
  P.out[3 * r + 1] = col.y;
  P.out[3 * r + 2] = col.z;
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// contiguous f32: ray_o, ray_d, out [n_rays*3]; ray_t [n_rays]; uni
// [n_bounces*11*n_rays]; tbl [(n_sph+n_tri)*24], 16-byte aligned; lt
// [max(1,n_lights)*6].
// Launches on `stream` on the caller's current device (the caller selects
// it), does not synchronise, and returns the cudaError_t of the launch
// (0 = success).
extern "C" int pt_megakernel_launch(
    void* stream, const float* ray_o, const float* ray_d, const float* ray_t,
    const float* uni, float* out, int n_rays, int n_bounces, const float* tbl,
    int n_sph, int n_tri, const float* lt, int n_lights, int russian_roulette,
    int shadow_len1) {
  if (n_rays <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(tbl) % 16) return (int)cudaErrorMisalignedAddress;
  if (n_sph < 0 || n_tri < 0 || n_lights < 0 || n_bounces < 0 ||
      n_sph > kMaxSpheres || n_tri > kMaxTris || n_lights > kMaxLights)
    return (int)cudaErrorInvalidValue;
  Params P{ray_o, ray_d, ray_t, uni, out, n_rays, n_bounces, tbl, lt,
           n_sph, n_tri, n_lights, russian_roulette, shadow_len1};
  // at the ceilings: (256 + 16) * 24 + 8 * 6 floats, 26 KB, under the 48 KB
  // a block gets without opting in
  const size_t smem = sizeof(float) *
      (size_t)((n_sph + n_tri) * kRowW + 6 * (n_lights > 1 ? n_lights : 1));
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  pt_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
