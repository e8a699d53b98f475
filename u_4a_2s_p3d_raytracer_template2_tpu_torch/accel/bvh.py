"""Per-object bounding boxes for the port's BVH build: ``object_bounds``,
copied from ``u_4a_2s_p3d_raytracer_template2_tpu/accel/bvh.py`` (NumPy only;
that module imports jax for its device arrays, so the port keeps its own
copy).

Planes have no bounding box (scene.h:75 returns a default AABB) and get
infinite bounds here; the walk tests them beside the tree
(``accel/packets.py``). The reference's spatial-median tree (``build_bvh``)
and its per-ray walk are not ported yet (ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

import numpy as np

from ..core import constants as C


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
