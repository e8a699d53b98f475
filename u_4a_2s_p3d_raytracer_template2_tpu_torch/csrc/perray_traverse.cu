// The reference's per-ray accelerator traversals for Hopper (sm_90a): the
// stack walk of the spatial-median BVH and the Amanatides-Woo DDA of the
// uniform grid, closest hit and any hit, one thread a ray.
//
// Replaces XLA loops of the JAX package (vmapped lax.while_loop programs
// compiled into the frame's one program, not Pallas kernels):
//   u_4a_2s_p3d_raytracer_template2_tpu/accel/traverse.py
//     _bvh_walk_single    (:70, its loops at :135 and :157)
//         -> median_bvh_closest_launch, median_bvh_any_launch;
//     _grid_walk_single   (:206, its loop at :272) -> grid_closest_launch;
//     _grid_shadow_single (:287, its loop at :350) -> grid_any_launch.
// Their plain version is accel/traverse.py's batched PyTorch, which steps
// every live ray once an iteration and reads the live rays on the host
// every few iterations. Here a ray loops in its own thread, its state in
// registers and its stack in a per-thread array (the device probe T3 read
// 4.12 ms for that placement against 6.95 ms for a stack in shared memory,
// PERF.md), and the host reads nothing, so a frame of these queries is one
// CUDA graph.
//
// Each query answers as the plain version does, bit for bit: the same f32
// operations in the same order (built without multiply-add contraction,
// kernels/build.NO_CONTRACTION), the primitive tests of prim_rows.cuh's
// row_t (ops/intersect.per_ray_t's), and the plain version's rules:
//   * BVH (BVH::Traverse, bvh.cpp:252-416): a node's entry t is the exit t
//     when the entry lies behind the origin, and 0 when the origin is
//     strictly inside its box; both children tested, each kept only if its
//     entry is <= the best t; the nearer descended (the left one only on a
//     strictly smaller entry), the farther pushed as (node, entry t), a
//     push past the stack's entries written to its top slot; a popped
//     entry taken only if its t < the best t; a leaf tests at most
//     kLeafMax objects in order and the first at the smallest t wins, a
//     later leaf only with a strictly smaller t; the any hit stops at its
//     first t < max_t.
//   * grid DDA (Grid::Traverse, grid.cpp:101-361): the first cell from the
//     entry point by an f32 -> int32 truncation (as PyTorch's CUDA cast
//     rounds), clamped; the next boundary t of an axis with d == 0 is
//     kBig; the walk leaves a cell through the first axis with the
//     smallest next t (x before y before z); a cell's closest hit is taken
//     only if its t < the cell's exit t (quirk #7), ending the walk; the
//     walk ends when the cell index reaches the axis' stop. The shadow DDA
//     stops at the first object with t < max_t; a ray whose grid entry
//     fails is occluded only under init_fail_occludes (grid.cpp:326-328).
//   * planes, which have no box, are tested beside the tree or the grid
//     (unbounded ids, -1 padded); a plane replaces the tree's or grid's
//     hit only at a strictly smaller t.
//   * dead slots are not traced: they read (kBig, -1), or occluded. The
//     live slots of a block are packed into its first threads inside the
//     launch (packing.cuh's for_live_slots), as the 4-wide walk packs its.
//   * ids are int32, -1 on a miss.
//
// The tables (kernels.perray_bvh_table, perray_grid_table, perray_rows),
// packed so that a step of the BVH walk costs one dependent read and a
// cell of the DDA two (its items, then their rows):
//   * the tree as 64 B records, one an inner node, numbered breadth first
//     (record 0 holds the root's box and reference): both children's boxes
//     (12 floats), then each child's index and its leaf flag with its
//     object count (4 ints): an inner child's record, or a leaf's first
//     row and count. A record is read as four float4 issued together, so
//     a visited inner node costs one round trip (JAX's arrays cost two: the
//     node's index and flag, then its children's boxes from six rows);
//   * the primitive rows in the tree's object order (then the planes'), so
//     a leaf's objects are consecutive rows, read together: one round trip,
//     with no hop through the order;
//   * the grid's items as each cell's count and its items in int4s, -1
//     padded to a multiple of 4: the DDA reads a cell's count and first
//     four items together, then tests the cell's objects only, not
//     max_per_cell slots one after another. Reading the next cell's
//     during the tests, or a four's rows before testing any, measured
//     slower (more registers and spills, fewer blocks an SM).
//
// What bounds it: per live ray 24 B in and 8 B (closest) or 1 B (any) out,
// tables that stay in L2 (the field's 7,396 rows are 473 KB, its 3,897
// records 249 KB), and the slab tests and primitive tests of the walk.
// Neither bounds it on the card: a ray's walk is a chain of dependent
// reads (each record names the next, each cell's items name its rows), so
// a launch is paced by its longest walks, each step a read's latency (an
// L1 or, mostly, L2 hit) and its tests. The design cuts the reads a step;
// what is left is the walks' length and a sparse launch's few live
// rays spread over all its blocks, for a coherence sort or a compaction of
// the live rays across blocks (ROADMAP). Tried on the card and not kept
// (PERF.md): the tree's top records in shared memory and a pushed child's
// record prefetched into L1 (both slower), a 16-entry stack for a tree
// that fits it (no faster than kStack).
//
// With a non-null counts [R, 9], zero on entry, each walk adds its work to
// its ray's row in the 4-wide walk's layout (kernels.WORK_COUNTS): in
// column 0 the BVH's node box tests (the root's and two a visited inner
// node) or the DDA's cell steps, then the primitive tests by where they
// ended, planes and boxes. The main path passes null and runs the
// instantiation without counters.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packing.cuh"
#include "prim_rows.cuh"

namespace {

constexpr int kStack = 64;    // accel/traverse.STACK
constexpr int kLeafMax = 4;   // accel/traverse.LEAF_MAX
constexpr int kThreads = 128;
constexpr int kNone = 0;  // no node: record 0, the root's, is no child

// the median BVH (kernels.perray_bvh_table): 64 B records, 4 float4 each;
// the primitive rows in its object order (n_order rows) come first in the
// rows table
struct Bvh {
  const float4* nodes;
  int n_records, n_order;
};

// the uniform grid (kernels.perray_grid_table): its box, each cell's count
// and its items in w4 int4s, -1 padded
struct Grid {
  const float* bmin;
  const float* bmax;
  const int4* items;
  const int* count;
  int nx, ny, nz, w4;
};

// the primitive table (kernels.perray_rows) and its planes: rows
// planes[j] of `rows`, or rows first + j where planes is null
struct Prims {
  const float4* rows;
  const int* planes;
  int first, n_planes;
};

// t of the object in row i (kBig on a miss, for i < 0 and for a row whose
// id is -1), its id in `id`
template <bool COUNT>
__device__ __forceinline__ float object_t(const float4* __restrict__ rows,
                                          int i, const Ray& r, int& id,
                                          Work& w) {
  id = -1;
  if (i < 0) return kBig;
  const float4 m = __ldg(rows + 4 * i + 3);
  if (__float_as_int(m.y) < 0) return kBig;
  int rank;
  return row_t<COUNT>(rows, i, m, __ldg(rows + 4 * i), r, rank, id, w);
}

__device__ __forceinline__ int plane_row(const Prims& P, int j) {
  return P.planes ? __ldg(P.planes + j) : P.first + j;
}

// The planes' closest hit (t, id): the first at the smallest t
template <bool COUNT>
__device__ __forceinline__ void planes_closest(const Prims& P, const Ray& r,
                                               float& tu, int& iu, Work& w) {
  tu = kBig;
  iu = -1;
  for (int j = 0; j < P.n_planes; ++j) {
    int id;
    const float t = object_t<COUNT>(P.rows, plane_row(P, j), r, id, w);
    if (t < tu) {
      tu = t;
      iu = id;
    }
  }
}

template <bool COUNT>
__device__ __forceinline__ bool planes_occlude(const Prims& P, const Ray& r,
                                               float max_t, Work& w) {
  int id;
  for (int j = 0; j < P.n_planes; ++j)
    if (object_t<COUNT>(P.rows, plane_row(P, j), r, id, w) < max_t)
      return true;
  return false;
}

// AABB::intercepts and isInside of the box (lo, hi): whether the ray's
// t > 0 half meets it, its entry t (the exit t when the entry is behind
// the origin), and whether the origin lies strictly inside
__device__ __forceinline__ void box_enter(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          const Ray& r, bool& hit,
                                          float& dist, bool& inside) {
  float a0, b0, a1, b1, a2, b2;
  slab_axis(lx, hx, r.ox, r.ix, a0, b0);
  slab_axis(ly, hy, r.oy, r.iy, a1, b1);
  slab_axis(lz, hz, r.oz, r.iz, a2, b2);
  const float t0 = fmaxf(fmaxf(a0, a1), a2);
  const float t1 = fminf(fminf(b0, b1), b2);
  hit = t0 < t1 && t1 > 0.f;
  dist = t0 < 0.f ? t1 : t0;
  inside = r.ox > lx && r.ox < hx && r.oy > ly && r.oy < hy && r.oz > lz &&
           r.oz < hz;
}

// A child's reference from its record's index and meta: an inner child's
// record (>= 1), or ~(first row * 8 + objects, at most kLeafMax) for a
// leaf (< 0)
__device__ __forceinline__ int child_ref(int index, int meta) {
  return meta < 0 ? index : ~(index * 8 + min(meta, kLeafMax));
}

// The tree's hit (t, id; kBig, -1 on a miss); ANY stops at the first t <
// max_t
template <bool ANY, bool COUNT>
__device__ float bvh_walk(const Bvh& B, const float4* __restrict__ rows,
                          const Ray& r, float max_t, int& ib, Work& w) {
  float tb = kBig;
  ib = -1;
  bool hit, inside;
  float dist;
  float4 q[4];  // record 0: the root's box and reference
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __ldg(B.nodes + i);
  box_enter(q[0].x, q[0].y, q[0].z, q[0].w, q[1].x, q[1].y, r, hit, dist,
            inside);
  if (COUNT) ++w.nodes;
  if (!hit) return tb;
  int stack_n[kStack];
  float stack_t[kStack];
  int sp = 0;
  int cur = child_ref(__float_as_int(q[3].x), __float_as_int(q[3].z));
  while (true) {
    if (cur < 0) {  // a leaf: its rows' type, id and first float4 read
                    // before any is tested
      const int first = (~cur) >> 3, count = (~cur) & 7;
      float4 p0[kLeafMax];
      float2 m[kLeafMax];
#pragma unroll
      for (int k = 0; k < kLeafMax; ++k) {
        if (k < count) {
          const int j = min(first + k, B.n_order - 1);
          m[k] = __ldg(reinterpret_cast<const float2*>(rows + 4 * j + 3));
          p0[k] = __ldg(rows + 4 * j);
        }
      }
      float lt = kBig;
      int lid = -1;
#pragma unroll
      for (int k = 0; k < kLeafMax; ++k) {
        if (k < count && __float_as_int(m[k].y) >= 0) {  // its k-th object
          int rank, id;
          const float t = row_t<COUNT>(
              rows, min(first + k, B.n_order - 1),
              make_float4(m[k].x, m[k].y, 0.f, 0.f), p0[k], r, rank, id, w);
          if (t < lt) {
            lt = t;
            lid = id;
          }
        }
      }
      if (lt < tb) {
        tb = lt;
        ib = lid;
      }
      cur = kNone;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = __ldg(B.nodes + 4 * cur + i);
      bool lhit, rhit, lin, rin;
      float ldist, rdist;
      box_enter(q[0].x, q[0].y, q[0].z, q[0].w, q[1].x, q[1].y, r, lhit,
                ldist, lin);
      box_enter(q[1].z, q[1].w, q[2].x, q[2].y, q[2].z, q[2].w, r, rhit,
                rdist, rin);
      if (COUNT) w.nodes += 2;
      if (lin) ldist = 0.f;
      if (rin) rdist = 0.f;
      lhit = lhit && ldist <= tb;  // pruned by the best hit
      rhit = rhit && rdist <= tb;
      const int li =
          child_ref(__float_as_int(q[3].x), __float_as_int(q[3].z));
      const int ri =
          child_ref(__float_as_int(q[3].y), __float_as_int(q[3].w));
      if (lhit && rhit) {
        const bool left_first = ldist < rdist;
        const int top = min(sp, kStack - 1);
        stack_n[top] = left_first ? ri : li;
        stack_t[top] = left_first ? rdist : ldist;
        ++sp;
        cur = left_first ? li : ri;
      } else {
        cur = lhit ? li : (rhit ? ri : kNone);
      }
    }
    if (ANY && tb < max_t) break;  // an occluder
    // the first pending entry nearer than the best hit
    while (cur == kNone && sp > 0) {
      --sp;
      const int top = min(sp, kStack - 1);
      if (stack_t[top] < tb) cur = stack_n[top];
    }
    if (cur == kNone) break;
  }
  return tb;
}

// The DDA of one ray: its cell, next boundary t, step in t, cell step and
// stop index on each axis
struct Dda {
  int cx, cy, cz, sx, sy, sz, ex, ey, ez;
  float tx, ty, tz, dtx, dty, dtz;
};

__device__ __forceinline__ void axis_setup(float lo_b, float hi_b, float o,
                                           float d, float tmin, float tmax,
                                           float t0, bool inside, int n,
                                           int& cell, float& t_next,
                                           float& dt, int& step, int& stop) {
  const float entry = inside ? o : o + d * t0;
  const float nf = (float)n;
  cell = min(max((int)((entry - lo_b) * nf / (hi_b - lo_b)), 0), n - 1);
  dt = (tmax - tmin) / nf;
  const bool fwd = d > 0.f;
  step = fwd ? 1 : -1;
  stop = fwd ? n : -1;
  t_next = fwd ? tmin + (float)(cell + 1) * dt
               : tmin + (nf - (float)cell) * dt;
  if (d == 0.f) t_next = kBig;
}

// Grid::Traverse's start (grid.cpp:101-180): returns whether the ray
// misses the grid
__device__ __forceinline__ bool dda_setup(const Grid& G, const Ray& r,
                                          Dda& s) {
  const float lx = __ldg(G.bmin), ly = __ldg(G.bmin + 1),
              lz = __ldg(G.bmin + 2);
  const float hx = __ldg(G.bmax), hy = __ldg(G.bmax + 1),
              hz = __ldg(G.bmax + 2);
  float a0, b0, a1, b1, a2, b2;
  slab_axis(lx, hx, r.ox, r.ix, a0, b0);
  slab_axis(ly, hy, r.oy, r.iy, a1, b1);
  slab_axis(lz, hz, r.oz, r.iz, a2, b2);
  const float t0 = fmaxf(fmaxf(a0, a1), a2);
  const float t1 = fminf(fminf(b0, b1), b2);
  const bool inside = r.ox > lx && r.ox < hx && r.oy > ly && r.oy < hy &&
                      r.oz > lz && r.oz < hz;
  axis_setup(lx, hx, r.ox, r.dx, a0, b0, t0, inside, G.nx, s.cx, s.tx, s.dtx,
             s.sx, s.ex);
  axis_setup(ly, hy, r.oy, r.dy, a1, b1, t0, inside, G.ny, s.cy, s.ty, s.dty,
             s.sy, s.ey);
  axis_setup(lz, hz, r.oz, r.dz, a2, b2, t0, inside, G.nz, s.cz, s.tz, s.dtz,
             s.sz, s.ez);
  return t0 > t1 || t1 < 0.f;
}

// A cell's count and first four items, read together; its index clamped
// into the grid
struct Cell {
  int c, n;
  int4 q;
};

__device__ __forceinline__ Cell read_cell(const Grid& G, const Dda& s) {
  const int x = min(max(s.cx, 0), G.nx - 1);
  const int y = min(max(s.cy, 0), G.ny - 1);
  const int z = min(max(s.cz, 0), G.nz - 1);
  Cell k;
  k.c = x + G.nx * (y + G.ny * z);
  k.n = __ldg(G.count + k.c);
  k.q = __ldg(G.items + (size_t)k.c * G.w4);
  return k;
}

// Leave the cell through the first axis with the smallest next t: returns
// that t (the cell's exit) and sets `out` when the walk leaves the grid
__device__ __forceinline__ float dda_step(Dda& s, bool& out) {
  int axis = 0;
  float t_exit = s.tx;
  if (s.ty < t_exit) {
    axis = 1;
    t_exit = s.ty;
  }
  if (s.tz < t_exit) {
    axis = 2;
    t_exit = s.tz;
  }
  if (axis == 0) {
    s.cx += s.sx;
    s.tx += s.dtx;
    out = s.cx == s.ex;
  } else if (axis == 1) {
    s.cy += s.sy;
    s.ty += s.dty;
    out = s.cy == s.ey;
  } else {
    s.cz += s.sz;
    s.tz += s.dtz;
    out = s.cz == s.ez;
  }
  return t_exit;
}

// The objects of cell k in item order, its items four at a time, each
// row read as it is tested (a cell holds 1.5 objects on the field's grid;
// reading a four's rows before testing any measured slower, with more
// registers, PERF.md): ANY returns true at
// the first t < max_t; otherwise (ct, cid) keeps the first at the
// smallest t
template <bool ANY, bool COUNT>
__device__ __forceinline__ bool cell_objects(const Grid& G,
                                             const float4* __restrict__ rows,
                                             Cell k, const Ray& r,
                                             float max_t, float& ct,
                                             int& cid, Work& w) {
  for (int b = 0; b < k.n; b += 4) {
    if (b > 0) k.q = __ldg(G.items + (size_t)k.c * G.w4 + b / 4);
    const int ids[4] = {k.q.x, k.q.y, k.q.z, k.q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (b + j < k.n) {
        int rank, id;
        const float t =
            row_t<COUNT>(rows, ids[j], __ldg(rows + 4 * ids[j] + 3),
                         __ldg(rows + 4 * ids[j]), r, rank, id, w);
        if (ANY) {
          if (t < max_t) return true;  // the shadow DDA's occluder
        } else if (t < ct) {
          ct = t;
          cid = ids[j];
        }
      }
    }
  }
  return false;
}

// The grid's closest hit (t, id; kBig, -1 when no cell takes one)
template <bool COUNT>
__device__ float grid_walk(const Grid& G, const float4* __restrict__ rows,
                           const Ray& r, int& ib, Work& w) {
  float tb = kBig;
  ib = -1;
  Dda s;
  if (dda_setup(G, r, s)) return tb;
  while (true) {
    const Cell k = read_cell(G, s);
    bool out;
    const float t_exit = dda_step(s, out);
    float ct = kBig;
    int cid = -1;
    cell_objects<false, COUNT>(G, rows, k, r, kBig, ct, cid, w);
    if (COUNT) ++w.nodes;
    if (ct < t_exit) {  // only a hit inside this cell's slab (quirk #7)
      tb = ct;
      ib = cid;
      break;
    }
    if (out) break;
  }
  return tb;
}

// The shadow DDA: whether an object of the grid has t < max_t, and in
// `misses` whether the ray's grid entry failed
template <bool COUNT>
__device__ bool grid_occluded(const Grid& G, const float4* __restrict__ rows,
                              const Ray& r, float max_t, bool& misses,
                              Work& w) {
  Dda s;
  misses = dda_setup(G, r, s);
  if (misses) return false;
  while (true) {
    const Cell k = read_cell(G, s);
    bool out;
    dda_step(s, out);
    float ct;
    int cid;
    if (cell_objects<true, COUNT>(G, rows, k, r, max_t, ct, cid, w))
      return true;
    if (COUNT) ++w.nodes;
    if (out) return false;
  }
}

// Closest hit of a slot: the tree's or grid's, or a plane's at a strictly
// smaller t; -1 where t is kBig
__device__ __forceinline__ void write_closest(float tb, int ib, float tu,
                                              int iu, float* out_t,
                                              int* out_id, int slot) {
  const float t = tu < tb ? tu : tb;
  const int id = tu < tb ? iu : ib;
  out_t[slot] = t;
  out_id[slot] = t >= kBig ? -1 : id;
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
median_bvh_closest_kernel(const float* __restrict__ o,
                          const float* __restrict__ d, int n_rays,
                          const uint8_t* __restrict__ dead, Bvh B, Prims P,
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
        const Ray r = make_ray(o + 3 * slot, d + 3 * slot);
        int ib, iu;
        float tu;
        const float tb = bvh_walk<false, COUNT>(B, P.rows, r, kBig, ib, w);
        planes_closest<COUNT>(P, r, tu, iu, w);
        write_closest(tb, ib, tu, iu, out_t, out_id, slot);
        add_work<COUNT>(counts, slot, w);
      });
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
median_bvh_any_kernel(const float* __restrict__ o,
                      const float* __restrict__ d, int n_rays, float max_t,
                      const uint8_t* __restrict__ dead, Bvh B, Prims P,
                      uint8_t* __restrict__ out, int* __restrict__ counts) {
  for_live_slots<kThreads>(
      n_rays, dead,
      [&](int slot) { out[slot] = 1; },  // a dead slot reports occluded
      [&](int slot) {
        Work w = {};
        const Ray r = make_ray(o + 3 * slot, d + 3 * slot);
        int ib;
        const bool occ = planes_occlude<COUNT>(P, r, max_t, w) ||
                         bvh_walk<true, COUNT>(B, P.rows, r, max_t, ib, w) <
                             max_t;
        out[slot] = occ ? 1 : 0;
        add_work<COUNT>(counts, slot, w);
      });
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
grid_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    int n_rays, const uint8_t* __restrict__ dead, Grid G,
                    Prims P, float* __restrict__ out_t,
                    int* __restrict__ out_id, int* __restrict__ counts) {
  for_live_slots<kThreads>(
      n_rays, dead,
      [&](int slot) {  // a dead slot: no hit
        out_t[slot] = kBig;
        out_id[slot] = -1;
      },
      [&](int slot) {
        Work w = {};
        const Ray r = make_ray(o + 3 * slot, d + 3 * slot);
        int ib, iu;
        float tu;
        const float tb = grid_walk<COUNT>(G, P.rows, r, ib, w);
        planes_closest<COUNT>(P, r, tu, iu, w);
        write_closest(tb, ib, tu, iu, out_t, out_id, slot);
        add_work<COUNT>(counts, slot, w);
      });
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
grid_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                int n_rays, float max_t, int init_fail_occludes,
                const uint8_t* __restrict__ dead, Grid G, Prims P,
                uint8_t* __restrict__ out, int* __restrict__ counts) {
  for_live_slots<kThreads>(
      n_rays, dead,
      [&](int slot) { out[slot] = 1; },  // a dead slot reports occluded
      [&](int slot) {
        Work w = {};
        const Ray r = make_ray(o + 3 * slot, d + 3 * slot);
        bool misses;
        bool occ = grid_occluded<COUNT>(G, P.rows, r, max_t, misses, w);
        if (init_fail_occludes && misses) occ = true;  // grid.cpp:326-328
        if (!occ) occ = planes_occlude<COUNT>(P, r, max_t, w);
        out[slot] = occ ? 1 : 0;
        add_work<COUNT>(counts, slot, w);
      });
}

int blocks(int n_slots) { return (n_slots + kThreads - 1) / kThreads; }

bool bad_bvh(const Bvh& B, int n_planes) {
  return B.n_records < 1 || B.n_order < 1 || n_planes < 0;
}

bool bad_grid(const Grid& G, int n_planes) {
  return G.nx < 1 || G.ny < 1 || G.nz < 1 || G.w4 < 1 || n_planes < 0;
}

}  // namespace

extern "C" int median_bvh_closest_launch(
    void* stream, const float* o, const float* d, int n_rays,
    const uint8_t* dead, const float* nodes, int n_records,
    const float* rows, int n_order, int n_planes, float* out_t, int* out_id,
    int* counts) {
  if (n_rays <= 0) return 0;
  const Bvh B{(const float4*)nodes, n_records, n_order};
  const Prims P{(const float4*)rows, nullptr, n_order, n_planes};
  if (bad_bvh(B, n_planes)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    median_bvh_closest_kernel<true><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, dead, B, P, out_t, out_id, counts);
  else
    median_bvh_closest_kernel<false><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, dead, B, P, out_t, out_id, counts);
  return (int)cudaGetLastError();
}

extern "C" int median_bvh_any_launch(
    void* stream, const float* o, const float* d, int n_rays, float max_t,
    const uint8_t* dead, const float* nodes, int n_records,
    const float* rows, int n_order, int n_planes, uint8_t* out,
    int* counts) {
  if (n_rays <= 0) return 0;
  const Bvh B{(const float4*)nodes, n_records, n_order};
  const Prims P{(const float4*)rows, nullptr, n_order, n_planes};
  if (bad_bvh(B, n_planes)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    median_bvh_any_kernel<true><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, max_t, dead, B, P, out, counts);
  else
    median_bvh_any_kernel<false><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, max_t, dead, B, P, out, counts);
  return (int)cudaGetLastError();
}

extern "C" int grid_closest_launch(
    void* stream, const float* o, const float* d, int n_rays,
    const uint8_t* dead, const float* bmin, const float* bmax,
    const int* items, const int* count, int nx, int ny, int nz, int w4,
    const float* rows, const int* unbounded, int n_unbounded, float* out_t,
    int* out_id, int* counts) {
  if (n_rays <= 0) return 0;
  const Grid G{bmin, bmax, (const int4*)items, count, nx, ny, nz, w4};
  const Prims P{(const float4*)rows, unbounded, 0, n_unbounded};
  if (bad_grid(G, n_unbounded)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    grid_closest_kernel<true><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, dead, G, P, out_t, out_id, counts);
  else
    grid_closest_kernel<false><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, dead, G, P, out_t, out_id, counts);
  return (int)cudaGetLastError();
}

extern "C" int grid_any_launch(
    void* stream, const float* o, const float* d, int n_rays, float max_t,
    int init_fail_occludes, const uint8_t* dead, const float* bmin,
    const float* bmax, const int* items, const int* count, int nx, int ny,
    int nz, int w4, const float* rows, const int* unbounded, int n_unbounded,
    uint8_t* out, int* counts) {
  if (n_rays <= 0) return 0;
  const Grid G{bmin, bmax, (const int4*)items, count, nx, ny, nz, w4};
  const Prims P{(const float4*)rows, unbounded, 0, n_unbounded};
  if (bad_grid(G, n_unbounded)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    grid_any_kernel<true><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, max_t, init_fail_occludes, dead, G, P, out, counts);
  else
    grid_any_kernel<false><<<blocks(n_rays), kThreads, 0, s>>>(
        o, d, n_rays, max_t, init_fail_occludes, dead, G, P, out, counts);
  return (int)cudaGetLastError();
}
