// BVH walk for Hopper (sm_90a): closest hit, any hit, and any hit for L
// segment sets that share their origins, one thread per live ray over a
// 4-wide tree of every bounded primitive (accel/packets.py builds the
// tables: one SAH tree, collapsed to four children a node).
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
//            that share their origins, one (set, ray) pair a thread; equal
//            to L one-set launches.
// Their plain version is accel/packets.py's level-by-level walk over the
// same tables.
//
// What bounds it: per live ray 24 B in, per slot 8 B (closest) or 1 B (any)
// out, and tables of tens to hundreds of KB that stay in L2; the work is
// the node slab tests and primitive tests the walk cannot prune. Neither
// bounds it on the card: a ray's walk is a chain of dependent node reads
// (each visit's children come from the previous read), so it is bound by
// latency. And a sweep level hands it every slot of a 512x512 frame's
// level (up to 2,097,152), of which few carry a ray (12% at level 1, 0.08%
// at level 3); the rest are `dead`. So:
//   * live slots only, packed inside the walk's own launch: a block takes
//     kThreads slots, writes each dead slot's answer ((kBig, -1), or
//     occluded), and packs its live slots in slot order into its first
//     threads (a ballot and a prefix in shared memory, packing.cuh's
//     for_live_slots, which the per-ray traversals share); the
//     warps left without a live slot end at once, so a dead slot costs its
//     mask byte and its answer, and no warp runs as long as its slowest
//     lane for lanes that have nothing to walk. No other launch runs and
//     the host reads no count. The walk is latency-bound, so the blocks
//     stay small: one block a slot range of kThreads keeps as many warps
//     in flight as the live rays allow (a persistent grid that packs a
//     longer range a block ran the dense primaries slower, each thread
//     walking its rays in turn).
//   * 4-wide nodes: a visit reads one node of 128 bytes (its four
//     children's boxes as six float4 rows, then their references and
//     counts), tests the four boxes together, pushes the hit children but
//     the nearest on a per-thread stack of (child, entry t), nearest last,
//     and goes on with the nearest. A binary tree spends one dependent read
//     per level, this one about half as many. Leaves are children: a leaf
//     child's rows are tested when it is taken.
//   * a closest-hit child is pruned when its entry is greater than the best
//     t (not >=, so an exact tie still reaches the tie rule), an any-hit
//     child when its entry is >= max_t; a child's box lies inside its
//     ancestors', so the answer is the same for any tree shape;
//   * nodes and primitive rows (64 B) read as float4 through the read-only
//     cache; a leaf's rows' type, id and first float4 are all read before
//     the first is tested, so that their reads overlap;
//   * the primitive tests are the brute-force formulas of ops/intersect.py
//     (direct (o-c) sphere form, Moller-Trumbore with |det| > eps and
//     t > eps, shared with brute_intersect.cu in prim_tests.cuh; slab
//     boxes, planes; a row's test, row_t, shared with the per-ray
//     traversals in prim_rows.cuh), and ties resolve as brute force does:
//     the smallest t, then type order triangle, sphere, plane, box, then the
//     lowest object id; planes, which have no box, are tested first, beside
//     the tree;
//   * 1/d uses the safe inverse (+-1e30 where |d| < 1e-30), since inactive
//     sweep slots trace axis-parallel rays;
//   * the host checks that the most entries the walk can hold fit kStack
//     (accel/packets.STACK_DEPTH), and the launch refuses tables of another
//     node width.
// With a non-null counts [R, 9], zero on entry (child box tests; triangle
// tests ended at the det, u and v gates and with their t; sphere tests
// ended at the discriminant and with their roots, prim_tests.cuh's stages;
// plane and box tests) each walk adds its work to its ray's row; the main
// path passes null and runs the instantiation without counters, which
// ignores the stages and compiles to the walk without them.
// All math is f32 with IEEE division and square root, built without
// multiply-add contraction (kernels/build.NO_CONTRACTION).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packing.cuh"
#include "prim_rows.cuh"

namespace {

constexpr int kStack = 64;      // accel/packets.STACK_DEPTH
constexpr int kWidth = 4;       // accel/packets.WIDTH: children a node
constexpr int kThreads = 128;
// A child as one int: its reference << kLeafBits | its leaf row count (0
// for an inner node); node 0, the root, is the walk's first item.
constexpr int kLeafBits = 3;
constexpr int kLeafMask = (1 << kLeafBits) - 1;
constexpr int kLeafRows = 4;    // accel/packets.LEAF_SIZE, at most kLeafMask

// The hit children of node n, nearest first: their codes and entry t in
// code[0, hits) and key[0, hits); returns hits. A child is hit when the
// ray's t >= 0 half meets its box and its entry is at most `limit` (a
// closest hit's best t) or, for an any hit, below it (max_t).
template <bool CLOSEST, bool COUNT>
__device__ __forceinline__ int visit(const float4* __restrict__ nodes, int n,
                                     const Ray& r, float limit,
                                     int (&code)[kWidth],
                                     float (&key)[kWidth], Work& w) {
  const float4* p = nodes + 2 * kWidth * n;
  float f[8 * kWidth];
#pragma unroll
  for (int q = 0; q < 2 * kWidth; ++q) {
    const float4 v = __ldg(p + q);
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
  int hits = 0;
#pragma unroll
  for (int c = 0; c < kWidth; ++c) {  // each child's box
    const int count = __float_as_int(f[7 * kWidth + c]);
    const float lx = (f[c] - r.ox) * r.ix;
    const float ly = (f[kWidth + c] - r.oy) * r.iy;
    const float lz = (f[2 * kWidth + c] - r.oz) * r.iz;
    const float hx = (f[3 * kWidth + c] - r.ox) * r.ix;
    const float hy = (f[4 * kWidth + c] - r.oy) * r.iy;
    const float hz = (f[5 * kWidth + c] - r.oz) * r.iz;
    const float tn = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)),
                           fminf(lz, hz));
    const float tf = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)),
                           fmaxf(lz, hz));
    const bool hit = count >= 0 && tn <= tf && tf >= 0.f &&
                     (CLOSEST ? tn <= limit : tn < limit);
    if (COUNT) w.nodes += count >= 0;
    code[c] = (__float_as_int(f[6 * kWidth + c]) << kLeafBits) | count;
    key[c] = hit ? tn : __int_as_float(0x7f800000);  // a miss sorts last
    hits += hit;
  }
  // insertion sort by entry t; a hit's is finite (at most limit)
#pragma unroll
  for (int i = 1; i < kWidth; ++i) {
#pragma unroll
    for (int j = i; j > 0; --j) {
      const bool swap = key[j] < key[j - 1];
      const float kt = key[j];
      const int ct = code[j];
      key[j] = swap ? key[j - 1] : kt;
      code[j] = swap ? code[j - 1] : ct;
      key[j - 1] = swap ? kt : key[j - 1];
      code[j - 1] = swap ? ct : code[j - 1];
    }
  }
  return hits;
}

// The rows of leaf m (first row, count): each row's type and id and its
// first float4, all read before any is tested, so that their reads overlap.
__device__ __forceinline__ void read_leaf(const float4* __restrict__ rows,
                                          int2 m, float4 (&head)[kLeafRows],
                                          float4 (&p0)[kLeafRows]) {
#pragma unroll
  for (int k = 0; k < kLeafRows; ++k) {
    if (k < m.y) {
      head[k] = __ldg(rows + 4 * (m.x + k) + 3);
      p0[k] = __ldg(rows + 4 * (m.x + k));
    }
  }
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
    float t = row_t<COUNT>(T.planes, j, __ldg(T.planes + 4 * j + 3),
                           __ldg(T.planes + 4 * j), r, rank, id, w);
    offer(t, rank, id);
  }

  int stack_c[kStack];
  float stack_t[kStack];
  int sp = 0;
  int item = 0;  // the root
  while (true) {
    if ((item & kLeafMask) == 0) {
      int code[kWidth];
      float key[kWidth];
      const int hits = visit<true, COUNT>(T.nodes, item >> kLeafBits, r, bt,
                                          code, key, w);
#pragma unroll
      for (int k = kWidth - 1; k > 0; --k) {
        if (k < hits) {
          stack_c[sp] = code[k];
          stack_t[sp] = key[k];
          ++sp;
        }
      }
      if (hits > 0) {
        item = code[0];
        continue;
      }
    } else {
      const int2 m = make_int2(item >> kLeafBits, item & kLeafMask);
      float4 head[kLeafRows], p0[kLeafRows];
      read_leaf(T.rows, m, head, p0);
#pragma unroll
      for (int k = 0; k < kLeafRows; ++k) {
        if (k < m.y) {  // row m.x + k of the leaf
          float t = row_t<COUNT>(T.rows, m.x + k, head[k], p0[k], r, rank,
                                 id, w);
          offer(t, rank, id);
        }
      }
    }
    // the nearest pending child that the best hit has not pruned
    while (sp > 0 && stack_t[sp - 1] > bt) --sp;
    if (sp == 0) break;
    item = stack_c[--sp];
  }
}

template <bool COUNT>
__device__ bool walk_any(const Tables& T, const Ray& r, float max_t,
                         Work& w) {
  int rank, id;
  for (int j = 0; j < T.n_planes; ++j)
    if (row_t<COUNT>(T.planes, j, __ldg(T.planes + 4 * j + 3),
                     __ldg(T.planes + 4 * j), r, rank, id, w) < max_t)
      return true;

  int stack_c[kStack];
  int sp = 0;
  int item = 0;  // the root
  while (true) {
    if ((item & kLeafMask) == 0) {
      int code[kWidth];
      float key[kWidth];
      const int hits = visit<false, COUNT>(T.nodes, item >> kLeafBits, r,
                                           max_t, code, key, w);
#pragma unroll
      for (int k = kWidth - 1; k > 0; --k)
        if (k < hits) stack_c[sp++] = code[k];
      if (hits > 0) {
        item = code[0];
        continue;
      }
    } else {
      const int2 m = make_int2(item >> kLeafBits, item & kLeafMask);
      float4 head[kLeafRows], p0[kLeafRows];
      read_leaf(T.rows, m, head, p0);
#pragma unroll
      for (int k = 0; k < kLeafRows; ++k) {
        if (k < m.y) {
          const float t = row_t<COUNT>(T.rows, m.x + k, head[k], p0[k], r,
                                       rank, id, w);
          if (t < max_t) return true;  // an occluder
        }
      }
    }
    if (sp == 0) return false;
    item = stack_c[--sp];
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               int n_rays, const uint8_t* __restrict__ dead, Tables T,
               float* __restrict__ out_t, int* __restrict__ out_id,
               int* __restrict__ counts) {
  for_live_slots<kThreads>(
      n_rays, dead,
      [&](int slot) {  // a dead slot: no hit
        out_t[slot] = kBig;
        out_id[slot] = -1;
      },
      [&](int slot) {
        Work w = {};
        float bt;
        int bid;
        walk_closest<COUNT>(T, make_ray(o + 3 * slot, d + 3 * slot), bt,
                            bid, w);
        out_t[slot] = bt;
        out_id[slot] = bt < kBig ? bid : -1;
        add_work<COUNT>(counts, slot, w);
      });
}

// L segment sets [L, R, 3] from one origin set [R, 3], one (set, ray) pair
// k = set * R + ray a slot; L = 1 is bvh_any.
template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ o, const float* __restrict__ dirs,
           int n_sets, int n_rays, float max_t,
           const uint8_t* __restrict__ dead, Tables T,
           uint8_t* __restrict__ out, int* __restrict__ counts) {
  for_live_slots<kThreads>(
      n_sets * n_rays, dead,
      [&](int k) { out[k] = 1; },  // a dead pair reports occluded
      [&](int k) {
        const int r = k % n_rays;
        Work w = {};
        out[k] = walk_any<COUNT>(T, make_ray(o + 3 * r, dirs + 3 * (size_t)k),
                                 max_t, w) ? 1 : 0;
        add_work<COUNT>(counts, r, w);
      });
}

int blocks(int n_slots) { return (n_slots + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int bvh_closest_launch(void* stream, const float* o,
                                  const float* d, int n_rays,
                                  const uint8_t* dead, const float* nodes,
                                  int width, const float* rows,
                                  const float* planes, int n_planes,
                                  float* out_t, int* out_id, int* counts) {
  if (n_rays <= 0) return 0;
  if (n_planes < 0 || width != kWidth) return (int)cudaErrorInvalidValue;
  Tables T{(const float4*)nodes, (const float4*)rows, (const float4*)planes,
           n_planes};
  cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    closest_kernel<true><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, dead, T, out_t, out_id, counts);
  else
    closest_kernel<false><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, dead, T, out_t, out_id, counts);
  return (int)cudaGetLastError();
}

extern "C" int bvh_any_launch(void* stream, const float* o,
                              const float* dirs, int n_sets, int n_rays,
                              float max_t, const uint8_t* dead,
                              const float* nodes, int width,
                              const float* rows, const float* planes,
                              int n_planes, uint8_t* out, int* counts) {
  if (n_rays <= 0 || n_sets <= 0) return 0;
  if (n_planes < 0 || width != kWidth) return (int)cudaErrorInvalidValue;
  Tables T{(const float4*)nodes, (const float4*)rows, (const float4*)planes,
           n_planes};
  const int n_slots = n_sets * n_rays;
  cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    any_kernel<true><<<blocks(n_slots), kThreads, 0, s>>>(
        o, dirs, n_sets, n_rays, max_t, dead, T, out, counts);
  else
    any_kernel<false><<<blocks(n_slots), kThreads, 0, s>>>(
        o, dirs, n_sets, n_rays, max_t, dead, T, out, counts);
  return (int)cudaGetLastError();
}
