// Native host-runtime components: BVH and uniform-grid construction over SoA
// bounds arrays.
//
// The reference builds its accelerators in C++ on the host (bvh.cpp:28-158,
// grid.cpp:30-98); this is the port's copy of the JAX package's builder
// (u_4a_2s_p3d_raytracer_template2_tpu/native/src/accel_build.cpp): same
// role, operating on flat SoA buffers that ship straight to the device, and
// exposed through a C ABI consumed via ctypes (no pybind11 dependency).
//
// Algorithms intentionally mirror the reference's decisions so leaf layouts
// are comparable (largest-extent axis w/ x>=y>=z tie preference, centroid
// sort, spatial-median -> centroid-mean -> left+threshold fallbacks,
// contiguous child pairs, leaf threshold 2).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Builds a flat BVH. Inputs: per-object AABBs [n][3]. Outputs are
// caller-allocated with capacity max_nodes = 2n (node arrays) and n (order).
// Returns the number of nodes written, or -1 on capacity overflow.
int rt_build_bvh(const float* bmin, const float* bmax, int n,
                 int threshold,
                 int* order,           // [n]      sorted object ids
                 float* node_min,      // [2n][3]
                 float* node_max,      // [2n][3]
                 uint8_t* node_leaf,   // [2n]
                 int* node_index,      // [2n]
                 int* node_nobjs)      // [2n]
{
    if (n <= 0) return 0;
    const int max_nodes = 2 * n;

    std::vector<float> cx(n), cy(n), cz(n);
    for (int i = 0; i < n; i++) {
        cx[i] = 0.5f * (bmin[3 * i + 0] + bmax[3 * i + 0]);
        cy[i] = 0.5f * (bmin[3 * i + 1] + bmax[3 * i + 1]);
        cz[i] = 0.5f * (bmin[3 * i + 2] + bmax[3 * i + 2]);
    }
    const float* cs[3] = {cx.data(), cy.data(), cz.data()};

    std::vector<int> perm(n);
    std::iota(perm.begin(), perm.end(), 0);

    int n_nodes = 0;
    auto push_node = [&](const float mn[3], const float mx[3]) -> int {
        if (n_nodes >= max_nodes) return -1;
        std::memcpy(node_min + 3 * n_nodes, mn, 3 * sizeof(float));
        std::memcpy(node_max + 3 * n_nodes, mx, 3 * sizeof(float));
        node_leaf[n_nodes] = 0;
        node_index[n_nodes] = 0;
        node_nobjs[n_nodes] = 0;
        return n_nodes++;
    };

    auto range_bbox = [&](int lo, int hi, float mn[3], float mx[3]) {
        for (int a = 0; a < 3; a++) {
            mn[a] = 1e30f;
            mx[a] = -1e30f;
        }
        for (int i = lo; i < hi; i++) {
            int o = perm[i];
            for (int a = 0; a < 3; a++) {
                mn[a] = std::min(mn[a], bmin[3 * o + a]);
                mx[a] = std::max(mx[a], bmax[3 * o + a]);
            }
        }
    };

    const float EPS = 1e-3f;
    float wmin[3], wmax[3];
    range_bbox(0, n, wmin, wmax);
    for (int a = 0; a < 3; a++) {  // world box ε-enlargement (bvh.cpp:41-42)
        wmin[a] -= EPS;
        wmax[a] += EPS;
    }
    int root = push_node(wmin, wmax);
    if (root < 0) return -1;

    struct Item { int lo, hi, node; };
    std::vector<Item> stack;
    stack.push_back({0, n, root});

    while (!stack.empty()) {
        Item it = stack.back();
        stack.pop_back();
        int lo = it.lo, hi = it.hi, node = it.node;

        if (hi - lo <= threshold) {
            node_leaf[node] = 1;
            node_index[node] = lo;
            node_nobjs[node] = hi - lo;
            continue;
        }

        const float* mn = node_min + 3 * node;
        const float* mx = node_max + 3 * node;
        float ext[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
        int axis;
        if (ext[0] >= ext[1] && ext[0] >= ext[2]) axis = 0;
        else if (ext[1] >= ext[0] && ext[1] >= ext[2]) axis = 1;
        else axis = 2;

        const float* c = cs[axis];
        std::stable_sort(perm.begin() + lo, perm.begin() + hi,
                         [&](int a, int b) { return c[a] < c[b]; });

        float mid = 0.5f * (mx[axis] + mn[axis]);
        // fallback 1: centroid mean (bvh.cpp:84-91)
        if (c[perm[lo]] > mid || c[perm[hi - 1]] <= mid) {
            double acc = 0.0;
            for (int i = lo; i < hi; i++) acc += c[perm[i]];
            mid = (float)(acc / (hi - lo));
        }
        int split;
        // fallback 2: left+threshold (bvh.cpp:95-97)
        if (c[perm[lo]] > mid || c[perm[hi - 1]] <= mid) {
            split = lo + threshold;
        } else {
            // first index with centroid > mid (sorted range)
            int s = lo, e = hi;
            while (s < e) {
                int m = s + (e - s) / 2;
                if (c[perm[m]] <= mid) s = m + 1; else e = m;
            }
            split = s;
        }

        float lmin[3], lmax[3], rmin[3], rmax[3];
        range_bbox(lo, split, lmin, lmax);
        range_bbox(split, hi, rmin, rmax);
        int li = push_node(lmin, lmax);
        int ri = push_node(rmin, rmax);
        if (li < 0 || ri < 0) return -1;
        node_leaf[node] = 0;
        node_index[node] = li;
        stack.push_back({split, hi, ri});
        stack.push_back({lo, split, li});
    }

    std::memcpy(order, perm.data(), n * sizeof(int));
    return n_nodes;
}

// Uniform grid (grid.cpp:30-98). Two-phase: call with items==nullptr to get
// the required max_per_cell; then with allocated outputs.
// Returns max_per_cell (phase 1) or 0 on success (phase 2); -1 on error.
int rt_build_grid(const float* bmin, const float* bmax, int n,
                  float m_factor,
                  float* gmin_out, float* gmax_out,   // [3]
                  int* dims_out,                      // [3] nx,ny,nz
                  int max_per_cell,                   // phase 2 capacity
                  int* items,                         // [ncells*max_per_cell]
                  int* counts)                        // [ncells]
{
    if (n <= 0) return -1;
    const float EPS = 1e-3f;
    float gmin[3] = {1e30f, 1e30f, 1e30f};
    float gmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < n; i++)
        for (int a = 0; a < 3; a++) {
            gmin[a] = std::min(gmin[a], bmin[3 * i + a]);
            gmax[a] = std::max(gmax[a], bmax[3 * i + a]);
        }
    for (int a = 0; a < 3; a++) {
        gmin[a] -= EPS;
        gmax[a] += EPS;
    }
    double w[3] = {gmax[0] - gmin[0], gmax[1] - gmin[1], gmax[2] - gmin[2]};
    double vol = std::max(w[0] * w[1] * w[2], 1e-12);
    double s = std::cbrt((double)n / vol);
    int nx = (int)(m_factor * w[0] * s + 1);
    int ny = (int)(m_factor * w[1] * s + 1);
    int nz = (int)(m_factor * w[2] * s + 1);
    long ncells = (long)nx * ny * nz;

    std::memcpy(gmin_out, gmin, sizeof(gmin));
    std::memcpy(gmax_out, gmax, sizeof(gmax));
    dims_out[0] = nx; dims_out[1] = ny; dims_out[2] = nz;

    auto cell_range = [&](int i, int lohi[6]) {
        for (int a = 0; a < 3; a++) {
            double na = dims_out[a];
            double wa = w[a];
            int lo = (int)std::clamp(
                (double)(bmin[3 * i + a] - gmin[a]) * na / wa, 0.0, na - 1);
            int hi = (int)std::clamp(
                (double)(bmax[3 * i + a] - gmin[a]) * na / wa, 0.0, na - 1);
            lohi[a] = lo;
            lohi[3 + a] = hi;
        }
    };

    std::vector<int> cnt(ncells, 0);
    for (int i = 0; i < n; i++) {
        int r[6];
        cell_range(i, r);
        for (int z = r[2]; z <= r[5]; z++)
            for (int y = r[1]; y <= r[4]; y++)
                for (int x = r[0]; x <= r[3]; x++)
                    cnt[x + (long)nx * y + (long)nx * ny * z]++;
    }
    int need = 0;
    for (long i = 0; i < ncells; i++) need = std::max(need, cnt[i]);

    if (items == nullptr) return need;
    if (max_per_cell < need) return -1;

    std::fill(items, items + ncells * (long)max_per_cell, -1);
    std::fill(counts, counts + ncells, 0);
    for (int i = 0; i < n; i++) {
        int r[6];
        cell_range(i, r);
        for (int z = r[2]; z <= r[5]; z++)
            for (int y = r[1]; y <= r[4]; y++)
                for (int x = r[0]; x <= r[3]; x++) {
                    long cidx = x + (long)nx * y + (long)nx * ny * z;
                    items[cidx * max_per_cell + counts[cidx]++] = i;
                }
    }
    return 0;
}

}  // extern "C"
