"""Binned-SAH treelet builder, copied as is from
``u_4a_2s_p3d_raytracer_template2_tpu/accel/sah.py`` (NumPy only). The port
calls it with small leaves (``accel/packets.LEAF_SIZE``) for its per-ray CUDA
walk; the text below is the JAX package's, written for its Pallas packet
kernel.

The reference carries a full SAH sweep it never calls
(bvh.cpp:183-235, `find_best_split`
alternates); its shipped build is spatial-median (bvh.cpp:77-126), which the
repo reproduces in ``accel/bvh.py`` for layout parity. This module is the
quality build the SAH code path was for: a standard 16-bin surface-area
heuristic, built here for 128-primitive *leaf chunks* — the unit the packet
kernel tests per node visit (one full VPU lane block), so "leaf" and
"MXU/VPU-efficient dense test" coincide.

Output layout (all host NumPy; uploaded by ``accel/packets.py``):
  nbox  [Nn, 6] f32 — node (bmin, bmax)
  nmeta [Nn, 2] i32 — internal: (left-child index, 0), children contiguous
                       (right = left+1, the bvh.cpp:149-153 addressing);
                       leaf: (chunk index, 1)
  chunk_prims [NC, leaf_size] i32 — global prim rows per leaf, -1 padded

Fill-rate guarantee (in ``leaf_size`` units): nodes with count in
(leaf_size, 2*leaf_size] split at exactly ``leaf_size`` along the widest
centroid axis, so at most one partially-filled *leaf* per binary tail — the
table stays ~N slots, not ~2N (VMEM residency is the point). When a leaf
spans several 128-wide lane blocks (leaf_chunks > 1 in accel/packets.py),
that one partial leaf expands to up to leaf_chunks mostly-empty blocks the
kernel folds on every visit; harmless at tree scale (>=MIN_TREE prims) since
only the tail leaf pays it.
"""
from __future__ import annotations

import numpy as np

LEAF = 128   # prims per leaf chunk = one VPU lane block
BINS = 16


def _surface(bmin, bmax):
    """Surface area of per-row AABBs; empty (inverted) boxes cost 0."""
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def sah_build(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int = LEAF,
              bins: int = BINS, strategy: str = "sah"):
    """Build the treelet BVH over prim bounds.

    ``strategy`` — "sah" (binned surface-area heuristic) or "median"
    (spatial median on the widest centroid axis, the reference's shipped
    build policy, bvh.cpp:77-126) — same tree/chunk layout either way, so
    the traversal kernels run both and the quality delta is measurable
    (tools/bench_packets.py sah-vs-median).

    Returns (order [n] i32 — permutation of input rows in tree order,
    nbox [Nn,6] f32, nmeta [Nn,2] i32, chunk_prims [NC, leaf_size] i32
    holding *input row indices*, -1 padded).
    """
    assert strategy in ("sah", "median"), strategy
    n = bmin.shape[0]
    assert n > 0
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    cent = 0.5 * (bmin + bmax)

    order = np.arange(n, dtype=np.int64)
    nboxes: list[np.ndarray] = []
    nmeta: list[tuple[int, int]] = []
    chunks: list[np.ndarray] = []

    def push(lo, hi):
        sel = order[lo:hi]
        nboxes.append(np.concatenate([bmin[sel].min(0), bmax[sel].max(0)]))
        nmeta.append((0, 0))
        return len(nboxes) - 1

    root = push(0, n)
    stack = [(0, n, root)]
    while stack:
        lo, hi, node = stack.pop()
        count = hi - lo
        if count <= leaf_size:
            nmeta[node] = (len(chunks), 1)
            chunks.append(order[lo:hi].copy())
            continue

        sel = order[lo:hi]
        cmin = cent[sel].min(0)
        cmax = cent[sel].max(0)
        split = None

        if count <= 2 * leaf_size:
            # full-leaf endgame: one full chunk + the remainder
            axis = int(np.argmax(cmax - cmin))
            order[lo:hi] = sel[np.argsort(cent[sel, axis], kind="stable")]
            split = lo + leaf_size
        elif strategy == "median":
            axis = int(np.argmax(cmax - cmin))
            order[lo:hi] = sel[np.argsort(cent[sel, axis], kind="stable")]
            split = lo + count // 2
        else:
            best_cost = np.inf
            best = None  # (axis, bin_of_each, threshold_bin)
            for axis in range(3):
                ext = cmax[axis] - cmin[axis]
                if ext < 1e-12:
                    continue
                b = np.clip(((cent[sel, axis] - cmin[axis]) * (bins / ext))
                            .astype(np.int64), 0, bins - 1)
                counts = np.bincount(b, minlength=bins)
                bb_min = np.full((bins, 3), np.inf)
                bb_max = np.full((bins, 3), -np.inf)
                np.minimum.at(bb_min, b, bmin[sel])
                np.maximum.at(bb_max, b, bmax[sel])
                # prefix/suffix running bounds and counts
                lmin = np.minimum.accumulate(bb_min, 0)
                lmax = np.maximum.accumulate(bb_max, 0)
                rmin = np.minimum.accumulate(bb_min[::-1], 0)[::-1]
                rmax = np.maximum.accumulate(bb_max[::-1], 0)[::-1]
                lcnt = np.cumsum(counts)
                rcnt = count - lcnt
                # split after bin k (k = 0..bins-2)
                k = np.arange(bins - 1)
                valid = (lcnt[k] > 0) & (rcnt[k] > 0)
                cost = np.where(
                    valid,
                    _surface(lmin[k], lmax[k]) * lcnt[k]
                    + _surface(rmin[k + 1], rmax[k + 1]) * rcnt[k],
                    np.inf)
                kb = int(np.argmin(cost))
                if cost[kb] < best_cost:
                    best_cost = cost[kb]
                    best = (axis, b, kb)
            if best is None:
                # all centroids coincide: arbitrary median split
                split = lo + count // 2
            else:
                axis, b, kb = best
                mask = b <= kb
                order[lo:hi] = np.concatenate([sel[mask], sel[~mask]])
                split = lo + int(mask.sum())

        li = push(lo, split)
        ri = push(split, hi)
        assert ri == li + 1
        nmeta[node] = (li, 0)
        stack.append((split, hi, ri))
        stack.append((lo, split, li))

    nc = len(chunks)
    chunk_prims = np.full((nc, leaf_size), -1, np.int64)
    for c, ids in enumerate(chunks):
        chunk_prims[c, : len(ids)] = ids
    return (order.astype(np.int32),
            np.asarray(nboxes, np.float32),
            np.asarray(nmeta, np.int32),
            chunk_prims.astype(np.int32))
