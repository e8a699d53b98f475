"""Host-side uniform grid construction (reference: Grid::Build,
grid.cpp:30-98); copied from ``u_4a_2s_p3d_raytracer_template2_tpu/accel/
grid.py`` (NumPy and the C++ builder of ``native/``; that module imports
jax for its device arrays).

Cell counts n = m·w·(N/V)^(1/3) + 1 with m = 2 (rayAccelerator.h:29);
objects are inserted into every overlapped cell (grid.cpp:75-91). The grid
ships as a dense padded [ncells, max_per_cell] item table, so the DDA of
accel/traverse.py reads a cell's items with one gather instead of the
reference's vector of vectors. The native and NumPy builders give the same
cells (the order inside a cell and the padding width may differ).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.types import GridArrays
from .bvh import bounded_ids, object_bounds, pad_ids

M_FACTOR = 2.0  # rayAccelerator.h:29


def _arrays(gmin, gmax, items, count, unbounded, dims, max_per_cell,
            device) -> GridArrays:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GridArrays(
        bbox_min=t(np.asarray(gmin, np.float32)),
        bbox_max=t(np.asarray(gmax, np.float32)),
        cell_items=t(items), cell_count=t(count),
        unbounded_ids=t(unbounded), nx=int(dims[0]), ny=int(dims[1]),
        nz=int(dims[2]), max_per_cell=int(max_per_cell))


def build_grid(params: np.ndarray, ptype: np.ndarray, *, device,
               use_native: bool = True) -> GridArrays:
    """The uniform grid of the boxed primitives of ``params`` [N, 12] /
    ``ptype`` [N], on ``device``; ``use_native`` takes the C++ builder when
    a compiler is there."""
    bmin, bmax = object_bounds(params, ptype)
    ids, unbounded = bounded_ids(ptype)

    if len(ids) == 0:
        return _arrays(np.zeros(3), np.ones(3), np.full((1, 1), -1, np.int32),
                       np.zeros(1, np.int32),
                       np.concatenate([unbounded, [-1]]).astype(np.int32),
                       (1, 1, 1), 1, device)

    if use_native:
        built = _build_grid_native(bmin[ids], bmax[ids], ids, unbounded,
                                   device)
        if built is not None:
            return built

    gmin = bmin[ids].min(axis=0) - C.EPSILON  # grid.cpp:49-50
    gmax = bmax[ids].max(axis=0) + C.EPSILON
    w = (gmax - gmin).astype(np.float64)
    nobj = len(ids)
    s = (nobj / max(w[0] * w[1] * w[2], 1e-12)) ** (1.0 / 3.0)
    nx = int(M_FACTOR * w[0] * s + 1)
    ny = int(M_FACTOR * w[1] * s + 1)
    nz = int(M_FACTOR * w[2] * s + 1)
    ncells = nx * ny * nz

    cells: list[list[int]] = [[] for _ in range(ncells)]
    for oid in ids:
        ob_min, ob_max = bmin[oid], bmax[oid]
        ixmin = int(np.clip((ob_min[0] - gmin[0]) * nx / w[0], 0, nx - 1))
        iymin = int(np.clip((ob_min[1] - gmin[1]) * ny / w[1], 0, ny - 1))
        izmin = int(np.clip((ob_min[2] - gmin[2]) * nz / w[2], 0, nz - 1))
        ixmax = int(np.clip((ob_max[0] - gmin[0]) * nx / w[0], 0, nx - 1))
        iymax = int(np.clip((ob_max[1] - gmin[1]) * ny / w[1], 0, ny - 1))
        izmax = int(np.clip((ob_max[2] - gmin[2]) * nz / w[2], 0, nz - 1))
        for iz in range(izmin, izmax + 1):
            for iy in range(iymin, iymax + 1):
                for ix in range(ixmin, ixmax + 1):
                    cells[ix + nx * iy + nx * ny * iz].append(int(oid))

    max_per_cell = max(1, max(len(c) for c in cells))
    # round up to a multiple of 8
    max_per_cell = ((max_per_cell + 7) // 8) * 8
    items = np.full((ncells, max_per_cell), -1, np.int32)
    count = np.zeros(ncells, np.int32)
    for i, c in enumerate(cells):
        items[i, : len(c)] = c
        count[i] = len(c)
    return _arrays(gmin, gmax, items, count, pad_ids(unbounded),
                   (nx, ny, nz), max_per_cell, device)


def _build_grid_native(bmin, bmax, ids, unbounded, device):
    """The C++ grid builder (native/src/accel_build.cpp); None without a
    compiler."""
    from .. import native

    lib = native.get_lib()
    if lib is None:
        return None
    import ctypes

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n = len(ids)
    bminf = np.ascontiguousarray(bmin, np.float32)
    bmaxf = np.ascontiguousarray(bmax, np.float32)
    gmin = np.zeros(3, np.float32)
    gmax = np.zeros(3, np.float32)
    dims = np.zeros(3, np.int32)
    # phase 1: the most items a cell holds
    need = lib.rt_build_grid(
        bminf.ctypes.data_as(fp), bmaxf.ctypes.data_as(fp), n,
        ctypes.c_float(M_FACTOR), gmin.ctypes.data_as(fp),
        gmax.ctypes.data_as(fp), dims.ctypes.data_as(ip), 0, None, None)
    if need < 0:
        raise RuntimeError("rt_build_grid found no objects")
    max_per_cell = max(1, ((need + 7) // 8) * 8)
    ncells = int(dims[0]) * int(dims[1]) * int(dims[2])
    items = np.zeros((ncells, max_per_cell), np.int32)
    counts = np.zeros(ncells, np.int32)
    rc = lib.rt_build_grid(
        bminf.ctypes.data_as(fp), bmaxf.ctypes.data_as(fp), n,
        ctypes.c_float(M_FACTOR), gmin.ctypes.data_as(fp),
        gmax.ctypes.data_as(fp), dims.ctypes.data_as(ip), max_per_cell,
        items.ctypes.data_as(ip), counts.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(f"rt_build_grid failed ({rc})")
    # local indices -> global object ids
    gids = np.asarray(ids, np.int32)
    items = np.where(items >= 0, gids[np.maximum(items, 0)], -1)
    return _arrays(gmin, gmax, items.astype(np.int32), counts,
                   pad_ids(unbounded), dims, max_per_cell, device)
