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
// per light for the shadow feeler, and the bounce count varies per path. The
// design follows from that:
//   * one thread per path, running its own bounce loop until the path dies
//     (sky miss, absorption, Russian roulette) or the bounces run out; the
//     ragged edge is masked with r < R, with no pad rays;
//   * the world arrives as operand tables (models/pt_megakernel.pt_tables):
//     [N*21] sphere then triangle rows, each with its material, and [L*6]
//     lights, copied into shared memory at block start; every thread of a
//     warp reads the same primitive at the same time, so reads are
//     broadcasts, and one build serves every world within the ceilings;
//   * shadow feelers stop at the first occluder;
//   * uniforms are read at [(b*11 + k)*R + r]: consecutive threads read
//     consecutive words.
// All math is f32 with IEEE division, square root, cbrtf, expf, sinf and
// cosf (no fast math). nvcc contracts multiply-adds (its default), as for
// the Whitted kernel (kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-3f;   // common.glsl:2, also t_min
constexpr float kTMax = 1e4f;   // P3D_RT.glsl:243
constexpr float kBig = 1e30f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530718f;  // ops/sampling.TWO_PI
constexpr int kRowW = 21;
constexpr int kGeomW = 9;
constexpr int kNU = 11;
constexpr int kThreads = 128;
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

// Sphere row: c0(3) c1(3) r t0 t1. The center is lerped by the ray's time;
// a zero time span means frac 0. GLSL half-b quadratic with the c>0 && b>0
// reject; t = t0 < 0 ? t1 : t0.
__device__ __forceinline__ V3 sphere_center(const float* p, float time) {
  const float span = p[8] - p[7];
  const float frac = span == 0.f ? 0.f : (time - p[7]) / span;
  const V3 c0 = load3(p);
  return c0 + (load3(p + 3) - c0) * frac;
}

__device__ __forceinline__ float sphere_t(const float* p, V3 o, V3 d, float time,
                                          float t_max) {
  const V3 L = o - sphere_center(p, time);
  const float b = dot(L, d);
  const float c = dot(L, L) - p[6] * p[6];
  if (c > 0.f && b > 0.f) return kBig;
  const float disc = b * b - c;
  if (!(disc >= 0.f)) return kBig;
  const float sq = sqrtf(disc);
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  const float t = t0 < 0.f ? t1 : t0;
  return (t > kEps && t < t_max) ? t : kBig;
}

// Triangle row: v0(3) e1(3) e2(3). Moller-Trumbore with a |det| > 1e-7
// cutoff, u and v in [0,1] but no u+v <= 1 guard (the GLSL quirk).
__device__ __forceinline__ float triangle_t(const float* p, V3 o, V3 d, float t_max) {
  const V3 e1 = load3(p + 3), e2 = load3(p + 6);
  const V3 h = cross(d, e2);
  const float det = dot(h, e1);
  if (!(fabsf(det) > 1e-7f)) return kBig;
  const float f = 1.f / det;
  const V3 s = o - load3(p);
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

// Closest hit: the first minimum among spheres, then a triangle only if
// strictly closer (hit_world's argmin and use_tri = tt < ts). Returns the
// row or -1.
__device__ __forceinline__ int closest(const World& w, V3 o, V3 d, float time,
                                       float& t_best) {
  t_best = kBig;
  int best = -1;
  for (int i = 0; i < w.n_sph; ++i) {
    const float t = sphere_t(w.rows + i * kRowW, o, d, time, kTMax);
    if (t < t_best) { t_best = t; best = i; }
  }
  for (int i = w.n_sph; i < w.n_sph + w.n_tri; ++i) {
    const float t = triangle_t(w.rows + i * kRowW, o, d, kTMax);
    if (t < t_best) { t_best = t; best = i; }
  }
  return best;
}

// any hit in (t_min, max_t); stops at the first occluder
__device__ __forceinline__ bool occluded(const World& w, V3 o, V3 d, float time,
                                         float max_t) {
  for (int i = 0; i < w.n_sph; ++i)
    if (sphere_t(w.rows + i * kRowW, o, d, time, max_t) < kBig) return true;
  for (int i = w.n_sph; i < w.n_sph + w.n_tri; ++i)
    if (triangle_t(w.rows + i * kRowW, o, d, max_t) < kBig) return true;
  return false;
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
  extern __shared__ float smem[];
  const int n_rows = P.n_sph + P.n_tri;
  const int n_lt = 6 * (P.n_lights > 1 ? P.n_lights : 1);
  float* s_rows = smem;
  float* s_lt = smem + n_rows * kRowW;
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
      n = normalize(cross(load3(p + 3), load3(p + 6)));
    }
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
// [n_bounces*11*n_rays]; tbl [(n_sph+n_tri)*21]; lt [max(1,n_lights)*6].
// Launches on `stream` on the caller's current device (the caller selects
// it), does not synchronise, and returns the cudaError_t of the launch
// (0 = success).
extern "C" int pt_megakernel_launch(
    void* stream, const float* ray_o, const float* ray_d, const float* ray_t,
    const float* uni, float* out, int n_rays, int n_bounces, const float* tbl,
    int n_sph, int n_tri, const float* lt, int n_lights, int russian_roulette,
    int shadow_len1) {
  if (n_rays <= 0) return 0;
  if (n_sph < 0 || n_tri < 0 || n_lights < 0 || n_bounces < 0 ||
      n_sph > kMaxSpheres || n_tri > kMaxTris || n_lights > kMaxLights)
    return (int)cudaErrorInvalidValue;
  Params P{ray_o, ray_d, ray_t, uni, out, n_rays, n_bounces, tbl, lt,
           n_sph, n_tri, n_lights, russian_roulette, shadow_len1};
  // at the ceilings: (256 + 16) * 21 + 8 * 6 floats, 23 KB, under the 48 KB
  // a block gets without opting in
  const size_t smem = sizeof(float) *
      (size_t)((n_sph + n_tri) * kRowW + 6 * (n_lights > 1 ? n_lights : 1));
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  pt_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
