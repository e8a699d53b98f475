// Brute-force closest hit and any hit for Hopper (sm_90a): every ray
// against every triangle and sphere of a scene, one thread per ray
// (ops/intersect.brute_tables packs the tables).
//
// Replaces the brute-force TPU kernels of the JAX package
//   u_4a_2s_p3d_raytracer_template2_tpu/ops/pallas_intersect.py
//     K4e triangle_closest    (_tri_kernel,       pallas_call at :590)
//     K4a sphere_closest      (_sphere_kernel,    pallas_call at :186)
//     K4b small_scene_closest (_make_small_kernel, pallas_call at :377)
//         -> brute_closest_launch with the triangle table, the sphere
//            table, or both (triangles before spheres, as K4b's
//            concatenated table orders them);
//     K4c sphere_any_hit      (_make_sphere_any_kernel, pallas_call at :525)
//     K4d triangle_any_hit    (_make_tri_any_kernel,    pallas_call at :553)
//         -> brute_any_launch with either table or both.
// Their plain version is ops/intersect.closest_hit_plain / any_hit_plain,
// the [R, chunk] blocks of PyTorch ops over the same primitives.
//
// What bounds it: operations. A ray reads 24 B and writes 8 B (closest) or
// 1 B (any), the tables are 20 B a sphere and 48 B a triangle, and every
// ray tests every primitive: 7,396 spheres a ray in the 7,396-sphere field,
// nearly all of them misses that end at the discriminant after about 20
// operations. So:
//   * one thread per ray; the block loads the tables into shared memory a
//     tile at a time (1,024 spheres or 512 triangles, coalesced float4
//     loads) and every thread folds the whole tile, reading each row as a
//     broadcast;
//   * the primitive tests are the formulas of ops/intersect.py operation
//     for operation (the direct (o-c) sphere form of _sphere_t_one,
//     Moller-Trumbore with |det| > eps and t > eps of _triangle_t_one),
//     shared with bvh_walk.cu in prim_tests.cuh, with an early return where
//     the plain version's answer is already a miss (a negative discriminant
//     skips the divisions and the square root);
//   * closest-hit ties resolve as the plain version and the BVH walk do:
//     the smallest t, then triangle before sphere, then the lower object
//     id, compared explicitly (table order is not relied on);
//   * any hit: a thread stops testing once occluded, and the block skips
//     its remaining tiles once every lane is (__syncthreads_and); dead
//     lanes and lanes past the last ray start occluded.
// With a non-null counts [R, 6] each thread records the tests it ran by
// where they ended: triangle tests at the det, u and v gates and with their
// t, then sphere tests at the discriminant and with their roots
// (prim_tests.cuh's stages); the main path passes null and runs the
// instantiation without counters.
// Built without multiply-add contraction (kernels/build.NO_CONTRACTION), so
// its f32 operations are the plain version's one for one: IEEE division
// and square root, no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prim_tests.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSphTile = 1024;  // (c, r) rows: 16 KB, ids 4 KB
constexpr int kTriTile = 512;   // (v0, e1, e2, id) rows: 24 KB

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float a;  // d.d
};

__device__ __forceinline__ Ray make_ray(const float* o, const float* d) {
  Ray r;
  r.ox = o[0]; r.oy = o[1]; r.oz = o[2];
  r.dx = d[0]; r.dy = d[1]; r.dz = d[2];
  r.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  return r;
}

// A thread's tests by where they ended (the counters' instantiation).
struct Work {
  int tri[kTriStages], sph[kSphStages];
};

template <int N>
__device__ __forceinline__ void tally(int (&c)[N], int stage) {
#pragma unroll
  for (int k = 0; k < N; ++k) c[k] += stage == k;
}

template <bool COUNT>
__device__ __forceinline__ void store_work(int* counts, int r,
                                           const Work& w) {
  if (COUNT) {
    int* c = counts + (kTriStages + kSphStages) * r;
#pragma unroll
    for (int k = 0; k < kTriStages; ++k) c[k] = w.tri[k];
#pragma unroll
    for (int k = 0; k < kSphStages; ++k) c[kTriStages + k] = w.sph[k];
  }
}

// An occluder is a hit closer than the segment's end.
__device__ __forceinline__ bool blocks(float t, float max_t) {
  return t < max_t;
}

// Tiles of `tile` rows that cover n rows, the last one partial.
__device__ __forceinline__ int n_tiles(int n, int tile) {
  return (n + tile - 1) / tile;
}

struct Tables {
  const float4* sph;   // [n_sph] (center, radius)
  const int* sph_id;   // [n_sph] global object ids
  int n_sph;
  const float4* tri;   // [n_tri, 3] (v0, e1, e2, id as int32 bits, pad)
  int n_tri;
};

// Rows [base, base + n) of a table into shared memory, w float4 a row.
__device__ __forceinline__ void load_tile(float4* dst,
                                          const float4* __restrict__ src,
                                          int base, int n, int w) {
  for (int i = threadIdx.x; i < w * n; i += kThreads)
    dst[i] = __ldg(src + w * base + i);
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               int n_rays, Tables T, float* __restrict__ out_t,
               int* __restrict__ out_id, int* __restrict__ counts) {
  __shared__ float4 s_row[3 * kTriTile];
  __shared__ int s_id[kSphTile];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < n_rays;
  Ray ray;
  if (live) ray = make_ray(o + 3 * r, d + 3 * r);
  float bt = kBig;
  int brank = 2, bid = 0x7fffffff;
  Work w = {};
  int stage;
  auto offer = [&](float t, int rank, int id) {
    if (t < kBig && (t < bt || (t == bt && (rank < brank ||
                                            (rank == brank && id < bid))))) {
      bt = t;
      brank = rank;
      bid = id;
    }
  };

  for (int k = 0; k < n_tiles(T.n_tri, kTriTile); ++k) {
    const int base = k * kTriTile;
    const int n = min(kTriTile, T.n_tri - base);
    __syncthreads();  // every thread has folded the previous tile
    load_tile(s_row, T.tri, base, n, 3);
    __syncthreads();
    if (live) {
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float4 p2 = s_row[3 * j + 2];
        offer(triangle_t(s_row[3 * j], s_row[3 * j + 1], p2, ray, stage), 0,
              __float_as_int(p2.y));
        if (COUNT) tally(w.tri, stage);
      }
    }
  }
  for (int k = 0; k < n_tiles(T.n_sph, kSphTile); ++k) {
    const int base = k * kSphTile;
    const int n = min(kSphTile, T.n_sph - base);
    __syncthreads();
    load_tile(s_row, T.sph, base, n, 1);
    for (int i = threadIdx.x; i < n; i += kThreads)
      s_id[i] = __ldg(T.sph_id + base + i);
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        offer(sphere_t(s_row[j], ray, stage), 1, s_id[j]);
        if (COUNT) tally(w.sph, stage);
      }
    }
  }
  if (!live) return;
  out_t[r] = bt;
  out_id[r] = bt < kBig ? bid : -1;
  store_work<COUNT>(counts, r, w);
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           int n_rays, float max_t, const uint8_t* __restrict__ dead,
           Tables T, uint8_t* __restrict__ out, int* __restrict__ counts) {
  __shared__ float4 s_row[3 * kTriTile];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < n_rays;
  // dead lanes report occluded without a test; lanes past the end are done
  bool occ = !live || (dead && dead[r]);
  Ray ray;
  if (live) ray = make_ray(o + 3 * r, d + 3 * r);
  Work w = {};
  int stage;

  for (int k = 0; k < n_tiles(T.n_tri, kTriTile); ++k) {
    // every lane occluded: skip the rest; else the barrier before the
    // previous tile is overwritten
    if (__syncthreads_and(occ)) break;
    const int base = k * kTriTile;
    const int n = min(kTriTile, T.n_tri - base);
    load_tile(s_row, T.tri, base, n, 3);
    __syncthreads();
    for (int j = 0; j < n && !occ; ++j) {
      occ = blocks(triangle_t(s_row[3 * j], s_row[3 * j + 1],
                              s_row[3 * j + 2], ray, stage), max_t);
      if (COUNT) tally(w.tri, stage);
    }
  }
  for (int k = 0; k < n_tiles(T.n_sph, kSphTile); ++k) {
    if (__syncthreads_and(occ)) break;
    const int base = k * kSphTile;
    const int n = min(kSphTile, T.n_sph - base);
    load_tile(s_row, T.sph, base, n, 1);
    __syncthreads();
    for (int j = 0; j < n && !occ; ++j) {
      occ = blocks(sphere_t(s_row[j], ray, stage), max_t);
      if (COUNT) tally(w.sph, stage);
    }
  }
  if (!live) return;
  out[r] = occ ? 1 : 0;
  store_work<COUNT>(counts, r, w);
}

}  // namespace

extern "C" int brute_closest_launch(void* stream, const float* o,
                                    const float* d, int n_rays,
                                    const float* sph, const int* sph_id,
                                    int n_sph, const float* tri, int n_tri,
                                    float* out_t, int* out_id, int* counts) {
  if (n_rays <= 0) return 0;
  if (n_sph < 0 || n_tri < 0) return (int)cudaErrorInvalidValue;
  Tables T{(const float4*)sph, sph_id, n_sph, (const float4*)tri, n_tri};
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

extern "C" int brute_any_launch(void* stream, const float* o, const float* d,
                                int n_rays, float max_t, const uint8_t* dead,
                                const float* sph, const int* sph_id,
                                int n_sph, const float* tri, int n_tri,
                                uint8_t* out, int* counts) {
  if (n_rays <= 0) return 0;
  if (n_sph < 0 || n_tri < 0) return (int)cudaErrorInvalidValue;
  Tables T{(const float4*)sph, sph_id, n_sph, (const float4*)tri, n_tri};
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    any_kernel<true><<<blocks, kThreads, 0, s>>>(o, d, n_rays, max_t, dead, T,
                                                 out, counts);
  else
    any_kernel<false><<<blocks, kThreads, 0, s>>>(o, d, n_rays, max_t, dead,
                                                  T, out, counts);
  return (int)cudaGetLastError();
}
