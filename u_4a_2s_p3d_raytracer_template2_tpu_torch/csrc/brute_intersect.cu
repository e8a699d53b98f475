// Brute-force closest hit and any hit for Hopper (sm_90a): every live ray
// against every triangle and sphere of a scene (ops/intersect.brute_tables
// packs the tables).
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
// live ray tests every row (an any hit up to its first occluder): 7,398
// rows a ray in the 7,396-sphere field, nearly all of them sphere misses
// that end at the discriminant. A sweep level hands the kernels every slot
// of a 512x512 frame's level (up to 2,097,152), of which few carry a ray
// (12% at level 1, 0.08% at level 3); the rest are `dead`. So:
//   * compaction: with a dead mask, brute_compact_count and
//     brute_compact_scatter pack the live slots' indices densely, in slot
//     order (a ballot and a prefix over the chunks before, packing.cuh,
//     shared with the BVH walk), and write the live count on the device;
//     they also write each dead slot's answer ((kBig, -1), or occluded)
//     and each live slot's starting state. The host never reads the
//     count: the sweeps read it, and work past it exits at once.
//   * work items: a sweep's grid is persistent (the blocks the card holds
//     at once) and loops over (ray group, table slice) items. The number
//     of slices is chosen on the device from the live count
//     (choose_slices): the fewest that keep the grid's last round of items
//     7/8 full, no slice under kMinSlice rows (closest) or kAnySlice rows
//     (any). Many live rays: few slices; a level-3 query's 1,647 rays: a
//     hundred slices, so the card stays full.
//   * closest hit: a block of kThreads threads takes kGroup rays, each
//     thread kRays of them, and sweeps its slice's rows through shared
//     memory a tile at a time (512 triangles or 1,024 spheres, coalesced
//     float4 loads); one broadcast row read feeds kRays tests, and the
//     row's r*r is computed once for them. Within an item a ray keeps its
//     best (t, rank, id) by the tie rule (the smallest t, then triangle
//     before sphere, then the lower object id, compared explicitly; the id
//     is read only when a test reaches its roots); then one 64-bit
//     atomicMin per (ray, slice) with a hit folds the slices into one key:
//     the bits of t (which order as unsigned integers for t >= 0; -0.0 is
//     keyed, and read back, as +0.0, which it equals), then the rank, then
//     the id, which is the tie rule exactly. brute_closest_finish writes
//     each live slot's (t, id), or (kBig, -1) where no slice hit.
//   * any hit: one warp per (live ray, slice); the 32 lanes test 32
//     consecutive rows (triangles, then spheres, in table order) and vote
//     after each step, so no lane idles while its warp sweeps for
//     another: a lit ray sweeps with every lane busy, an occluded ray
//     stops within 32 rows of its first occluder. Rows come through L1
//     (the kernel asks for the most L1); triangle rows are 48 B apart. A
//     slice that finds an occluder sets the ray's output byte, which is
//     also its flag: the other slices of that ray read it every
//     kFlagEvery steps and stop.
//   * the sphere test reads its discriminant's sign first: with
//     b = 2 (d.l), bb = b*b and ac = 4a * cc computed as the plain version
//     computes them, its delta is fl(bb - ac), and delta >= 0 implies
//     bb >= ac (an exact difference of floats is 0 or at least 2^-149 in
//     magnitude; inf - inf is NaN and fails delta >= 0, so the gate only
//     passes more). The gate is bb >= ac; the rare tests that pass it
//     compute delta = bb - ac and the roots exactly as the plain version
//     does (sphere_roots), so every answer is the plain version's, bit for
//     bit, with no argument about overflow or subnormals. The gate saves
//     the subtraction; r*r and 4a are per-row and per-ray constants. A
//     closest-hit thread computes its kRays gates of a row as one straight
//     run of independent operations and branches once, where one branch a
//     ray would cut the row into blocks the scheduler cannot interleave;
//     its triangle rows likewise run the triangle test to its u gate for
//     kRays rays (TriGate: triangle_t's formulas, split there), then
//     branch once.
// The decisions are f32 comparisons over products of depth 3: no TF32 and
// no tensor cores (the JAX package's matrix-unit sphere form loses about 8
// bits), and the source is built without multiply-add contraction
// (kernels/build.NO_CONTRACTION), so its f32 operations are the plain
// version's one for one: IEEE division and square root, no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packing.cuh"
#include "prim_tests.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 128;            // closest hit: threads a block
constexpr int kRays = 4;                 // closest hit: rays a thread
constexpr int kGroup = kThreads * kRays;  // closest hit: rays a work item
constexpr int kSphTile = 1024;           // (c, r) rows: 16 KB
constexpr int kTriTile = 512;            // (v0, e1, e2, id) rows: 24 KB
constexpr int kMinSlice = 64;            // closest hit: fewest rows a slice
constexpr int kAnyThreads = 256;         // any hit: 8 warps a block
constexpr int kAnyWarps = kAnyThreads / 32;
constexpr int kAnySlice = 256;           // any hit: fewest rows a slice
constexpr int kFlagEvery = 8;            // any hit: steps between flag reads
constexpr int kScanThreads = 256;        // compaction: threads a block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kChunk = 4096;             // compaction: slots a block
constexpr unsigned long long kNoKey = ~0ull;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float a;   // d.d
  float a4;  // 4a, as the plain version's 4 * a * cc starts
};

__device__ __forceinline__ Ray make_ray(const float* o, const float* d) {
  Ray r;
  r.ox = o[0]; r.oy = o[1]; r.oz = o[2];
  r.dx = d[0]; r.dy = d[1]; r.dz = d[2];
  r.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  r.a4 = 4.f * r.a;
  return r;
}

// A ray past the live count: NaN directions end every test at its first
// gate, and its answer is never written.
__device__ __forceinline__ Ray no_ray() {
  Ray r;
  r.ox = r.oy = r.oz = 0.f;
  r.dx = r.dy = r.dz = r.a = r.a4 = __int_as_float(0x7fc00000);
  return r;
}

// An occluder is a hit closer than the segment's end.
__device__ __forceinline__ bool blocks(float t, float max_t) {
  return t < max_t;
}

struct Tables {
  const float4* sph;   // [n_sph] (center, radius)
  const int* sph_id;   // [n_sph] global object ids
  int n_sph;
  const float4* tri;   // [n_tri, 3] (v0, e1, e2, id as int32 bits, pad)
  int n_tri;
};

// What a query writes: the closest hit's answer and per-ray keys, or the
// any hit's occlusion bytes.
struct Outputs {
  float* t;
  int* id;
  unsigned long long* key;
  uint8_t* occ;
};

// The live count: the compaction's, on the device, else every slot.
__device__ __forceinline__ int live_count(const int* n_live, int n_slots) {
  return n_live ? *n_live : n_slots;
}

// The fewest table slices for `units` ray units (groups or rays) that keep
// the last round of `grid` workers at least 7/8 busy; at most `most`.
__device__ __forceinline__ int choose_slices(int units, int grid, int most) {
  for (int s = 1; s < most; ++s) {
    const long long items = (long long)units * s;
    const long long rounds = (items + grid - 1) / grid;
    if (8 * items >= 7 * rounds * grid) return s;
  }
  return most;
}

// ---------------------------------------------------------------------------
// compaction of the live slots

__device__ __forceinline__ int block_sum(int v, int* s_warp) {
  for (int k = 16; k > 0; k >>= 1) v += __shfl_xor_sync(kAll, v, k);
  __syncthreads();  // s_warp is free
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x / 32] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) total += s_warp[w];
  return total;
}

// Live slots of each chunk of kChunk slots: counts[chunk].
__global__ void __launch_bounds__(kScanThreads)
brute_compact_count(const uint8_t* __restrict__ dead, int n_slots,
                    int* __restrict__ counts) {
  const int base = blockIdx.x * kChunk;
  int live = 0;
  for (int k = threadIdx.x; k < kChunk; k += kScanThreads)
    live += base + k < n_slots && !dead[base + k];
  __shared__ int s_warp[kScanWarps];
  live = block_sum(live, s_warp);
  if (threadIdx.x == 0) counts[blockIdx.x] = live;
}

__device__ __forceinline__ void init_slot(const Outputs& out, int slot,
                                          int at, bool live) {
  if (out.occ) {
    out.occ[slot] = !live;  // a dead slot reports occluded, a live one lit
  } else if (live) {
    out.key[at] = kNoKey;
  } else {
    out.t[slot] = kBig;  // a dead slot: no hit
    out.id[slot] = -1;
  }
}

// The live slots' indices in slot order (idx), their count (n_live), and
// each slot's starting state (init_slot).
__global__ void __launch_bounds__(kScanThreads)
brute_compact_scatter(const uint8_t* __restrict__ dead, int n_slots,
                      const int* __restrict__ counts, int* __restrict__ idx,
                      int* __restrict__ n_live, Outputs out) {
  __shared__ int s_warp[kScanWarps];
  int before = 0;  // live slots of the chunks before this one
  for (int c = threadIdx.x; c < blockIdx.x; c += kScanThreads)
    before += counts[c];
  int at0 = block_sum(before, s_warp);
  const int base = blockIdx.x * kChunk;
  for (int k = 0; k < kChunk; k += kScanThreads) {
    const int slot = base + k + threadIdx.x;
    const bool in = slot < n_slots;
    const bool live = in && !dead[slot];
    int round;
    const int at = at0 + block_prefix<kScanWarps>(live, s_warp, round);
    if (live) idx[at] = slot;
    if (in) init_slot(out, slot, at, live);
    at0 += round;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *n_live = at0;
}

// ---------------------------------------------------------------------------
// closest hit

// A ray's best hit within a work item, by the tie rule.
struct Best {
  float t;
  int rank, id;
  __device__ __forceinline__ void offer(float tt, int r, int i) {
    if (tt < kBig && (tt < t || (tt == t && (r < rank ||
                                             (r == rank && i < id))))) {
      t = tt;
      rank = r;
      id = i;
    }
  }
};

// (t, rank, id) as one key whose unsigned order is the tie rule; t >= 0.
__device__ __forceinline__ unsigned long long key_of(const Best& b) {
  const unsigned tb = b.t == 0.f ? 0u : __float_as_uint(b.t);
  return ((unsigned long long)tb << 32) | ((unsigned)b.rank << 31) |
         (unsigned)b.id;
}

// Rows [base, base + n) of a table into shared memory, w float4 a row.
__device__ __forceinline__ void load_tile(float4* dst,
                                          const float4* __restrict__ src,
                                          int base, int n, int w) {
  for (int i = threadIdx.x; i < w * n; i += kThreads)
    dst[i] = __ldg(src + w * base + i);
}

__global__ void __launch_bounds__(kThreads)
brute_closest_sweep(const float* __restrict__ o, const float* __restrict__ d,
                    int n_slots, const int* __restrict__ idx,
                    const int* __restrict__ n_live, Tables T,
                    unsigned long long* __restrict__ key) {
  __shared__ float4 s_row[3 * kTriTile];
  const int n = live_count(n_live, n_slots);
  const int groups = (n + kGroup - 1) / kGroup;
  const int n_rows = T.n_tri + T.n_sph;
  const int slices = choose_slices(groups, gridDim.x,
                                   max(1, n_rows / kMinSlice));
  const int per = (n_rows + slices - 1) / slices;  // rows a slice
  for (int w = blockIdx.x; w < groups * slices; w += gridDim.x) {
    const int g = w / slices;
    const int lo = (w % slices) * per, hi = min(n_rows, lo + per);
    Ray ray[kRays];
    Best best[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int i = g * kGroup + k * kThreads + threadIdx.x;
      if (i < n) {
        const int slot = idx ? idx[i] : i;
        ray[k] = make_ray(o + 3 * slot, d + 3 * slot);
      } else {
        ray[k] = no_ray();
      }
      best[k] = Best{kBig, 2, 0x7fffffff};
    }
    const int tri_hi = min(hi, T.n_tri);
    for (int base = lo; base < tri_hi; base += kTriTile) {
      const int m = min(kTriTile, tri_hi - base);
      __syncthreads();  // every thread has swept the previous tile
      load_tile(s_row, T.tri, base, m, 3);
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < m; ++j) {
        const float4 p0 = s_row[3 * j], p1 = s_row[3 * j + 1],
                     p2 = s_row[3 * j + 2];
        TriGate gate[kRays];
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
        }
      }
    }
    const int sph_hi = hi - T.n_tri;
    for (int base = max(lo - T.n_tri, 0); base < sph_hi; base += kSphTile) {
      const int m = min(kSphTile, sph_hi - base);
      __syncthreads();
      load_tile(s_row, T.sph, base, m, 1);
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < m; ++j) {
        const float4 p = s_row[j];
        const float rr = p.w * p.w;
        // the kRays gates as one straight run of independent operations,
        // then one branch, rarely taken
        Gate gate[kRays];
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
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int i = g * kGroup + k * kThreads + threadIdx.x;
      if (i < n && best[k].t < kBig) atomicMin(key + i, key_of(best[k]));
    }
  }
}

// Each live slot's (t, id) from its key.
__global__ void brute_closest_finish(int n_slots, const int* __restrict__ idx,
                                     const int* __restrict__ n_live,
                                     const unsigned long long* __restrict__ key,
                                     float* __restrict__ out_t,
                                     int* __restrict__ out_id) {
  const int n = live_count(n_live, n_slots);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int slot = idx ? idx[i] : i;
    const unsigned long long k = key[i];
    out_t[slot] = k == kNoKey ? kBig : __uint_as_float((unsigned)(k >> 32));
    out_id[slot] = k == kNoKey ? -1 : (int)(k & 0x7fffffffu);
  }
}

// ---------------------------------------------------------------------------
// any hit

// Whether any lane of the warp found an occluder.
__device__ __forceinline__ bool vote(bool hit) {
  return __any_sync(kAll, hit);
}

__global__ void __launch_bounds__(kAnyThreads)
brute_any_sweep(const float* __restrict__ o, const float* __restrict__ d,
                int n_slots, const int* __restrict__ idx,
                const int* __restrict__ n_live, float max_t, Tables T,
                uint8_t* out) {
  const int n = live_count(n_live, n_slots);
  const int warps = gridDim.x * kAnyWarps;
  const int n_rows = T.n_tri + T.n_sph;
  const int slices = choose_slices(n, warps, max(1, n_rows / kAnySlice));
  const int per = (n_rows + slices - 1) / slices;
  const int lane = threadIdx.x & 31;
  for (int w = blockIdx.x * kAnyWarps + threadIdx.x / 32; w < n * slices;
       w += warps) {
    const int i = w / slices;
    const int lo = (w % slices) * per, hi = min(n_rows, lo + per);
    const int slot = idx ? idx[i] : i;
    const Ray r = make_ray(o + 3 * slot, d + 3 * slot);
    volatile uint8_t* flag = out + slot;
    bool occ = false;
    for (int base = lo; base < hi && !occ; base += 32) {
      // another slice of this ray found an occluder: stop
      if (slices > 1 && (base - lo) % (32 * kFlagEvery) == 0 &&
          vote(*flag != 0))
        break;
      const int j = base + lane;
      bool hit = false;
      if (j < hi) {
        if (j < T.n_tri) {
          const float4* p = T.tri + 3 * j;
          const float4 p0 = __ldg(p), p1 = __ldg(p + 1), p2 = __ldg(p + 2);
          const TriGate g = triangle_gate(p0, p1, p2, r);
          hit = g.open() && blocks(g.t(p0, p1, p2, r), max_t);
        } else {
          const float4 p = __ldg(T.sph + j - T.n_tri);
          const Gate g = sphere_gate(p, p.w * p.w, r);
          hit = g.open() && blocks(g.t(r), max_t);
        }
      }
      occ = vote(hit);
    }
    if (occ && lane == 0) *flag = 1;
  }
}

// ---------------------------------------------------------------------------
// launches

// Blocks of `threads` that the card holds at once for `kernel`; `l1` asks
// for the most L1 on this device first (the any hit reads its rows there).
int persistent_grid(const void* kernel, int threads, int which, bool l1) {
  static int cache[2][64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  int& grid = cache[which][dev];
  if (grid == 0) {
    if (l1)
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxL1);
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    grid = max(1, sms) * max(1, per_sm);
  }
  return grid;
}

int n_chunks(int n_slots) { return (n_slots + kChunk - 1) / kChunk; }

// The scratch a launch carves: per-ray keys (closest), then with a dead
// mask the live indices, the live count and the chunks' counts.
struct Scratch {
  unsigned long long* key;
  int* idx;
  int* n_live;
  int* counts;
};

long long scratch_bytes(int n_slots, bool closest, bool masked) {
  return (closest ? 8ll * n_slots : 0) +
         (masked ? 4ll * n_slots + 4 + 4ll * n_chunks(n_slots) : 0);
}

Scratch carve(void* scratch, int n_slots, bool closest, bool masked) {
  char* p = (char*)scratch;
  Scratch s{nullptr, nullptr, nullptr, nullptr};
  if (closest) {
    s.key = (unsigned long long*)p;
    p += 8ll * n_slots;
  }
  if (masked) {
    s.idx = (int*)p;
    s.n_live = s.idx + n_slots;
    s.counts = s.n_live + 1;
  }
  return s;
}

void compact(cudaStream_t st, const uint8_t* dead, int n_slots,
             const Scratch& s, const Outputs& out) {
  brute_compact_count<<<n_chunks(n_slots), kScanThreads, 0, st>>>(
      dead, n_slots, s.counts);
  brute_compact_scatter<<<n_chunks(n_slots), kScanThreads, 0, st>>>(
      dead, n_slots, s.counts, s.idx, s.n_live, out);
}

}  // namespace

// Bytes of scratch that a launch over n_rays slots needs.
extern "C" long long brute_scratch_bytes(int n_rays, int closest, int masked) {
  return scratch_bytes(n_rays, closest != 0, masked != 0);
}

extern "C" int brute_closest_launch(void* stream, const float* o,
                                    const float* d, int n_rays,
                                    const uint8_t* dead, const float* sph,
                                    const int* sph_id, int n_sph,
                                    const float* tri, int n_tri,
                                    float* out_t, int* out_id,
                                    void* scratch) {
  if (n_rays <= 0) return 0;
  if (n_sph < 0 || n_tri < 0 || !scratch) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch s = carve(scratch, n_rays, true, dead != nullptr);
  if (dead) {
    compact(st, dead, n_rays, s, Outputs{out_t, out_id, s.key, nullptr});
  } else {
    const cudaError_t e = cudaMemsetAsync(s.key, 0xff, 8ll * n_rays, st);
    if (e != cudaSuccess) return (int)e;
  }
  Tables T{(const float4*)sph, sph_id, n_sph, (const float4*)tri, n_tri};
  const int grid = persistent_grid((const void*)brute_closest_sweep,
                                   kThreads, 0, false);
  brute_closest_sweep<<<grid, kThreads, 0, st>>>(o, d, n_rays, s.idx,
                                                 s.n_live, T, s.key);
  brute_closest_finish<<<min((n_rays + 255) / 256, 1024), 256, 0, st>>>(
      n_rays, s.idx, s.n_live, s.key, out_t, out_id);
  return (int)cudaGetLastError();
}

extern "C" int brute_any_launch(void* stream, const float* o, const float* d,
                                int n_rays, float max_t, const uint8_t* dead,
                                const float* sph, const int* sph_id,
                                int n_sph, const float* tri, int n_tri,
                                uint8_t* out, void* scratch) {
  if (n_rays <= 0) return 0;
  if (n_sph < 0 || n_tri < 0 || (dead && !scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch s = carve(scratch, n_rays, false, dead != nullptr);
  if (dead) {
    compact(st, dead, n_rays, s, Outputs{nullptr, nullptr, nullptr, out});
  } else {
    const cudaError_t e = cudaMemsetAsync(out, 0, n_rays, st);
    if (e != cudaSuccess) return (int)e;
  }
  Tables T{(const float4*)sph, sph_id, n_sph, (const float4*)tri, n_tri};
  const int grid = persistent_grid((const void*)brute_any_sweep, kAnyThreads,
                                   1, true);
  brute_any_sweep<<<grid, kAnyThreads, 0, st>>>(o, d, n_rays, s.idx,
                                                s.n_live, max_t, T, out);
  return (int)cudaGetLastError();
}
