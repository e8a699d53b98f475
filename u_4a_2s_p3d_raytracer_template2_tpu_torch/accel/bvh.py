"""Host-side BVH construction: ``object_bounds`` (the per-object boxes the
port's SAH tree of accel/packets.py is built on) and ``build_bvh``, the
reference's spatial-median tree as flat arrays; copied from
``u_4a_2s_p3d_raytracer_template2_tpu/accel/bvh.py`` (NumPy only; that
module imports jax for its device arrays, so the port keeps its own copy).

``build_bvh`` reproduces the reference build's ordering decisions
(bvh.cpp:28-158) so leaf contents and node layout are comparable: leaf
threshold 2, split axis = largest extent, objects sorted by centroid along
the axis, spatial-median split point with fallback to centroid-mean and
then to ``left+Threshold``, children allocated as a contiguous pair
addressed by one index (bvh.cpp:149-153), leaves indexing into the sorted
object order (bvh.cpp:55). The C++ builder (``native/``) runs the same
algorithm; the NumPy one below serves a machine without a compiler, and
the two give equal tables. The JAX module's host copy of the last build's
order (``last_host_order``) fed its cluster tables, a TPU workaround the
port does not have.

Planes have no bounding box (scene.h:75 returns a default AABB) and get
infinite bounds here; the port's walk tests them beside the tree
(``accel/packets.py``), the per-ray traversals via ``unbounded_ids``
(``accel/traverse.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.types import BvhArrays

THRESHOLD = 2  # leaf size (rayAccelerator.h:72)


def object_bounds(params: np.ndarray, ptype: np.ndarray):
    """AABB per object: [N,3] min / max.

    triangle boxes are ε-padded like the Triangle ctor (scene.cpp:37-39).
    """
    n = params.shape[0]
    params = np.asarray(params, np.float32)
    ptype = np.asarray(ptype)
    bmin = np.full((n, 3), -np.inf, np.float32)  # plane/invalid: unbounded
    bmax = np.full((n, 3), np.inf, np.float32)

    t = ptype[:, None]
    c = params[:, 0:3]
    r = params[:, 3:4]
    bmin = np.where(t == C.SPHERE, c - r, bmin)
    bmax = np.where(t == C.SPHERE, c + r, bmax)

    v0 = params[:, 0:3]
    v1 = v0 + params[:, 3:6]
    v2 = v0 + params[:, 6:9]
    tmin = np.minimum(np.minimum(v0, v1), v2) - C.EPSILON
    tmax = np.maximum(np.maximum(v0, v1), v2) + C.EPSILON
    bmin = np.where(t == C.TRIANGLE, tmin, bmin)
    bmax = np.where(t == C.TRIANGLE, tmax, bmax)

    bmin = np.where(t == C.AABOX, params[:, 0:3], bmin)
    bmax = np.where(t == C.AABOX, params[:, 3:6], bmax)
    return bmin, bmax


def _build_core_native(cmin: np.ndarray, cmax: np.ndarray):
    """The C++ builder (native/src/accel_build.cpp): the same algorithm and
    outputs as the NumPy path; None without a compiler."""
    from .. import native

    lib = native.get_lib()
    if lib is None:
        return None
    import ctypes

    n = cmin.shape[0]
    cminf = np.ascontiguousarray(cmin, np.float32)
    cmaxf = np.ascontiguousarray(cmax, np.float32)
    order = np.zeros(n, np.int32)
    node_min = np.zeros((2 * n, 3), np.float32)
    node_max = np.zeros((2 * n, 3), np.float32)
    leaf = np.zeros(2 * n, np.uint8)
    index = np.zeros(2 * n, np.int32)
    nobjs = np.zeros(2 * n, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    k = lib.rt_build_bvh(
        cminf.ctypes.data_as(fp), cmaxf.ctypes.data_as(fp), n, THRESHOLD,
        order.ctypes.data_as(ip),
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        leaf.ctypes.data_as(u8p), index.ctypes.data_as(ip),
        nobjs.ctypes.data_as(ip))
    if k < 0:
        raise RuntimeError(f"rt_build_bvh overflowed its {2 * n} nodes")
    return (order, node_min[:k], node_max[:k], leaf[:k].astype(bool),
            index[:k], nobjs[:k])


def bounded_ids(ptype: np.ndarray):
    """(ids of the boxed primitives: triangles, spheres, boxes; ids of the
    unbounded ones: planes), int32, INVALID padding in neither."""
    ptype = np.asarray(ptype)
    bounded = np.isin(ptype, (C.SPHERE, C.TRIANGLE, C.AABOX))
    return (np.nonzero(bounded)[0].astype(np.int32),
            np.nonzero(~bounded & (ptype != C.INVALID))[0].astype(np.int32))


def pad_ids(ids: np.ndarray) -> np.ndarray:
    """``ids`` -1-padded to a multiple of 8 (at least 8)."""
    pad = max(8, ((max(len(ids), 1) + 7) // 8) * 8)
    out = np.full(pad, -1, np.int32)
    out[:len(ids)] = ids
    return out


def build_bvh(params: np.ndarray, ptype: np.ndarray, *, device,
              use_native: bool = True) -> BvhArrays:
    """The spatial-median BVH of the boxed primitives of ``params``
    [N, 12] / ``ptype`` [N], on ``device``; ``use_native`` takes the C++
    builder when a compiler is there."""
    bmin, bmax = object_bounds(params, ptype)
    order, unbounded = bounded_ids(ptype)
    cmin = bmin[order]
    cmax = bmax[order]
    centroid = 0.5 * (cmin + cmax)
    n = len(order)

    if use_native and n > 0:
        built = _build_core_native(cmin, cmax)
        if built is not None:
            perm_order, nmins, nmaxs, nleafs, nidxs, nnobjs = built
            return _pack(order[perm_order], unbounded, nmins, nmaxs, nleafs,
                         nidxs, nnobjs, n, device)
    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    nodes_leaf: list[bool] = []
    nodes_index: list[int] = []
    nodes_nobj: list[int] = []

    perm = np.arange(n)

    def node_bbox(lo, hi):
        if hi <= lo:
            return (np.full(3, np.inf, np.float32),
                    np.full(3, -np.inf, np.float32))
        sel = perm[lo:hi]
        return cmin[sel].min(axis=0), cmax[sel].max(axis=0)

    def push(mn, mx):
        nodes_min.append(mn)
        nodes_max.append(mx)
        nodes_leaf.append(False)
        nodes_index.append(0)
        nodes_nobj.append(0)
        return len(nodes_min) - 1

    if n > 0:
        wmin, wmax = node_bbox(0, n)
        wmin = wmin - C.EPSILON  # world box ε-enlargement (bvh.cpp:41-42)
        wmax = wmax + C.EPSILON
        root = push(wmin, wmax)
        stack = [(0, n, root)]
        while stack:
            lo, hi, node = stack.pop()
            if hi - lo <= THRESHOLD:
                nodes_leaf[node] = True
                nodes_index[node] = lo
                nodes_nobj[node] = hi - lo
                continue
            mn, mx = nodes_min[node], nodes_max[node]
            ext = mx - mn
            # largest-extent axis with the reference's tie preferences
            # (bvh.cpp:64-70): x wins ties over y and z; y over z
            if ext[0] >= ext[1] and ext[0] >= ext[2]:
                axis = 0
            elif ext[1] >= ext[0] and ext[1] >= ext[2]:
                axis = 1
            else:
                axis = 2
            seg = perm[lo:hi]
            seg = seg[np.argsort(centroid[seg, axis], kind="stable")]
            perm[lo:hi] = seg
            cs = centroid[seg, axis]

            mid = 0.5 * (mx[axis] + mn[axis])
            # fallback 1: centroid mean if the spatial median empties a
            # side (bvh.cpp:84-91)
            if cs[0] > mid or cs[-1] <= mid:
                mid = cs.mean()
            # fallback 2: left+Threshold if still degenerate (bvh.cpp:95-97)
            if cs[0] > mid or cs[-1] <= mid:
                split = lo + THRESHOLD
            else:
                split = lo + int(np.searchsorted(cs, mid, side="right"))
            lmin, lmax = node_bbox(lo, split)
            rmin, rmax = node_bbox(split, hi)
            li = push(lmin, lmax)
            ri = push(rmin, rmax)
            assert ri == li + 1
            nodes_leaf[node] = False
            nodes_index[node] = li
            stack.append((split, hi, ri))
            stack.append((lo, split, li))

    return _pack(
        order[perm] if n > 0 else np.zeros(0, np.int32), unbounded,
        np.asarray(nodes_min, np.float32).reshape(-1, 3),
        np.asarray(nodes_max, np.float32).reshape(-1, 3),
        np.asarray(nodes_leaf, bool), np.asarray(nodes_index, np.int32),
        np.asarray(nodes_nobj, np.int32), n, device)


def _pack(sorted_order, unbounded, nodes_min, nodes_max, nodes_leaf,
          nodes_index, nodes_nobj, n, device) -> BvhArrays:
    k = max(1, len(nodes_min))
    pad_k = max(8, ((k + 7) // 8) * 8)
    arr_min = np.zeros((pad_k, 3), np.float32)
    arr_max = np.zeros((pad_k, 3), np.float32)
    arr_leaf = np.zeros(pad_k, bool)
    arr_index = np.zeros(pad_k, np.int32)
    arr_nobj = np.zeros(pad_k, np.int32)
    kk = len(nodes_min)
    arr_min[:kk] = nodes_min
    arr_max[:kk] = nodes_max
    arr_leaf[:kk] = nodes_leaf
    arr_index[:kk] = nodes_index
    arr_nobj[:kk] = nodes_nobj

    pad_n = max(8, ((max(n, 1) + 7) // 8) * 8)
    order_arr = np.full(pad_n, -1, np.int32)
    order_arr[:n] = sorted_order

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BvhArrays(
        bbox_min=t(arr_min), bbox_max=t(arr_max), leaf=t(arr_leaf),
        index=t(arr_index), n_objs=t(arr_nobj), order=t(order_arr),
        unbounded_ids=t(pad_ids(unbounded)), n_nodes=kk, n_bounded=n)
