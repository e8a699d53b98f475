"""The port's BVH accelerator: one SAH tree over every bounded primitive,
collapsed to four children a node and walked per ray; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/accel/packets.py``, whose public names
it keeps.

The JAX module walks per-type treelets of 128-lane leaf chunks with one
Pallas program per 256-ray packet (K5a-K5d). On a GPU a thread walks its own
ray with a small stack, so the layout here is the GPU's:

  * ``nodes`` [Nn, 8·W] f32, W = ``WIDTH`` children a node (128 bytes at
    W = 4): the children's boxes as six rows of W (min x, min y, min z,
    max x, max y, max z), then W int32 references and W int32 counts
    stored as bits. A child with count 0 is the inner node at its
    reference, one with count > 0 a leaf of that many rows from its
    reference, and count -1 marks an unused child. Node 0 is the root.
    The tree is ``sah_build``'s binary tree over ``object_bounds``
    (triangles ε-padded), collapsed: a node takes its binary children and
    opens the inner one of largest surface area until it has W
    (``_collapse``), so its boxes are the binary tree's.
  * ``rows`` [P, 16] f32: every triangle, sphere and box in leaf order, as
    the 12 parameters of ``prims.params``, the type code and the global
    object id (int32 bits), and 2 pad floats (64 bytes a row).
  * ``planes`` [Kp, 16] f32 in the same row layout: planes have no box and
    are tested beside the tree.

``csrc/bvh_walk.cu`` walks these tables on CUDA tensors
(``kernels.bvh_closest``, ``bvh_any``, ``bvh_any_multi``). The plain
version below walks the same tables level by level on any device, with the
primitive tests of ``ops/intersect.py`` and brute force's tie rule (the
smallest t, then type order triangle, sphere, plane, box, then the lowest
object id), so on the CPU it returns exactly what brute force returns. A
closest-hit child is pruned only when its entry t is greater than the best
hit's, so exact ties reach the tie rule, and an any-hit child when its
entry is at or past max_t; a child's box lies inside its ancestors', so the
answer does not depend on the tree's shape. The dispatch functions run the
plain version on CPU tensors and the kernel on CUDA tensors, never one in
place of the other. JAX's ``multi_supported`` has no counterpart: the fused
multi-light walk takes any tree, where JAX's kernel had a ceiling of 96
leaf chunks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import constants as C
from ..core.types import Rays
from ..ops import intersect
from .bvh import object_bounds
from .sah import sah_build

LEAF_SIZE = 4      # primitives per leaf: a thread's leaf visit tests each
STACK_DEPTH = 64   # the kernel's per-thread stack (kStack in bvh_walk.cu)
WIDTH = 4          # children a node (kWidth in bvh_walk.cu)
ROW_W = 16         # floats per primitive row
BINARY_W = 8       # floats per node of the binary tree: box, (child, count)
_RANK = {C.TRIANGLE: 0, C.SPHERE: 1, C.PLANE: 2, C.AABOX: 3}
_CHUNK = 1 << 16   # rays per step of the plain walk (bounds its frontier)


@dataclasses.dataclass(frozen=True)
class PacketTables:
    """The tree and its primitive rows on one device (see the module
    docstring for the layout)."""

    nodes: torch.Tensor   # [Nn, 8 * width] f32
    rows: torch.Tensor    # [P, ROW_W] f32
    planes: torch.Tensor  # [Kp, ROW_W] f32
    depth: int = 1        # nodes on the binary tree's longest path
    stack: int = 0        # the most entries the walk's stack holds

    @property
    def width(self) -> int:
        return self.nodes.shape[1] // 8


def _rows(params: np.ndarray, ptype: np.ndarray, ids: np.ndarray):
    r = np.zeros((len(ids), ROW_W), np.float32)
    r[:, :12] = params[ids]
    bits = r.view(np.int32)
    bits[:, 12] = ptype[ids]
    bits[:, 13] = ids
    return r


def _depth(nmeta: np.ndarray) -> int:
    depth, level, frontier = 0, 0, [0]
    while frontier:
        level += 1
        nxt = []
        for n in frontier:
            a, leaf = nmeta[n]
            if leaf:
                depth = max(depth, level)
            else:
                nxt += [a, a + 1]
        frontier = nxt
    return depth


def _binary_build(params: np.ndarray, ptype: np.ndarray):
    """The binary SAH tree over the bounded objects of ``params`` [N, 12],
    ``ptype`` [N]: (nodes [Nn, BINARY_W] f32 of box and, as int32 bits,
    inner ``(left child, 0)`` with the right child at ``left + 1`` or leaf
    ``(first row, count > 0)``; rows; planes; depth), or None when no
    object has a box. This is the table the walk read before its nodes
    were four wide; ``binary_tables`` uploads it for a build of that
    walk."""
    params = np.asarray(params, np.float32)
    ptype = np.asarray(ptype)
    bounded = np.nonzero((ptype == C.TRIANGLE) | (ptype == C.SPHERE)
                         | (ptype == C.AABOX))[0]
    if len(bounded) == 0:
        return None
    bmin, bmax = object_bounds(params, ptype)
    _, nbox, nmeta, chunk_prims = sah_build(bmin[bounded], bmax[bounded],
                                            leaf_size=LEAF_SIZE)
    # leaf rows in chunk order; a leaf's meta becomes (first row, count)
    counts = (chunk_prims >= 0).sum(axis=1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = bounded[chunk_prims[chunk_prims >= 0]]
    leaf = nmeta[:, 1] == 1
    chunk = np.where(leaf, nmeta[:, 0], 0)
    meta = np.where(leaf[:, None],
                    np.stack([starts[chunk], counts[chunk]], 1),
                    np.stack([nmeta[:, 0], np.zeros_like(nmeta[:, 0])], 1))
    nodes = np.zeros((nbox.shape[0], BINARY_W), np.float32)
    nodes[:, :6] = nbox
    nodes.view(np.int32)[:, 6:8] = meta
    planes = np.nonzero(ptype == C.PLANE)[0]
    return (nodes, _rows(params, ptype, order), _rows(params, ptype, planes),
            _depth(nmeta))


def _collapse(binary: np.ndarray, width: int):
    """The ``width``-wide tree of the binary nodes [Nn, BINARY_W]:
    (nodes [Nw, 8 * width] f32, stack), nodes in breadth-first order from
    the root. Each node takes its binary node's two children and opens the
    inner child of largest surface area (the first of equals) until it has
    ``width`` children or only leaves; a binary tree whose root is a leaf
    gives a root of one child. ``stack`` is the most entries the walk can
    hold: a visit pushes every hit child but the nearest, so the largest
    sum over a root-to-node path of each node's children less one."""
    box = binary[:, :6]
    meta = binary[:, 6:8].view(np.int32)
    ext = np.maximum(box[:, 3:] - box[:, :3], 0.0)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0])

    def children(n):
        if meta[n, 1] > 0:
            return [n]
        kids = [meta[n, 0], meta[n, 0] + 1]
        while len(kids) < width:
            inner = [i for i, k in enumerate(kids) if meta[k, 1] == 0]
            if not inner:
                break
            i = max(inner, key=lambda i: area[kids[i]])
            a = meta[kids[i], 0]
            kids[i:i + 1] = [a, a + 1]
        return kids

    order, above, wide, stack = [0], [0], [], 0
    for n, held in zip(order, above):  # grows while it is read
        kids = children(n)
        row = np.zeros(8 * width, np.float32)
        bits = row.view(np.int32)
        bits[7 * width:] = -1
        for i, k in enumerate(kids):
            row[i:6 * width:width] = box[k]
            if meta[k, 1] > 0:
                bits[6 * width + i], bits[7 * width + i] = meta[k]
            else:
                bits[6 * width + i], bits[7 * width + i] = len(order), 0
                order.append(k)
                above.append(held + len(kids) - 1)
        stack = max(stack, held + len(kids) - 1)
        wide.append(row)
    return np.stack(wide), stack


def _upload(nodes, rows, planes, device, **extra) -> PacketTables:
    def t(a):
        return torch.from_numpy(a).to(device)

    return PacketTables(nodes=t(nodes), rows=t(rows), planes=t(planes),
                        **extra)


def build_packets(params: np.ndarray, ptype: np.ndarray, *, device,
                  width: int = WIDTH) -> PacketTables | None:
    """Host build of the tree over the objects ``params`` [N, 12],
    ``ptype`` [N] (no padding rows), ``width`` children a node, uploaded
    to ``device``. None when no object has a box (planes only). Raises if
    the walk could hold more entries than the kernel's stack."""
    binary = _binary_build(params, ptype)
    if binary is None:
        return None
    nodes, rows, planes, depth = binary
    nodes, stack = _collapse(nodes, width)
    if stack > STACK_DEPTH:
        raise ValueError(f"the walk of this BVH can hold {stack} entries, "
                         f"more than its stack of {STACK_DEPTH}")
    return _upload(nodes, rows, planes, device, depth=depth, stack=stack)


def binary_tables(params: np.ndarray, ptype: np.ndarray, *,
                  device) -> PacketTables | None:
    """The binary tree's tables (``_binary_build``) on ``device``, in the
    layout the walk read before its nodes were four wide: nodes [Nn,
    BINARY_W]. Only tools that time that walk beside this one read them."""
    binary = _binary_build(params, ptype)
    if binary is None:
        return None
    nodes, rows, planes, depth = binary
    return _upload(nodes, rows, planes, device, depth=depth, stack=depth)


# ---------------------------------------------------------------------------
# the plain version: a level-by-level walk of (ray, node) pairs


def _children(pt: PacketTables):
    """Each node's children: (boxes [Nn, 6, W] as rows of min x, min y,
    min z, max x, max y, max z; references [Nn, W] i64; counts [Nn, W]
    i64)."""
    n, w = pt.nodes.shape[0], pt.width
    meta = pt.nodes[:, 6 * w:].contiguous().view(torch.int32).long()
    return (pt.nodes[:, :6 * w].reshape(n, 6, w), meta[:, :w],
            meta[:, w:])


def _slab(box, o, inv):
    """Entry and exit t of rays (o, inv) through boxes [K, 6]."""
    lo = (box[:, 0:3] - o) * inv
    hi = (box[:, 3:6] - o) * inv
    return (torch.minimum(lo, hi).amax(dim=-1),
            torch.maximum(lo, hi).amin(dim=-1))


def _row_t(rows, o, d, inv):
    """Each row's primitive test against its own ray: t [M], BIG on miss
    (the formulas of ops/intersect.py)."""
    code = rows[:, 12].contiguous().view(torch.int32)
    t = torch.full(code.shape, C.BIG, dtype=o.dtype, device=o.device)
    for c in (C.TRIANGLE, C.SPHERE, C.PLANE, C.AABOX):
        sel = torch.nonzero(code == c).squeeze(1)
        if sel.numel():
            p = rows[sel]
            t[sel] = intersect._prim_t(
                c, [p[:, k] for k in range(12)], intersect._cols3(o[sel]),
                intersect._cols3(d[sel]), intersect._cols3(inv[sel]))
    return t


def _row_key(rows):
    """Tie key of each row: type rank << 32 | object id (int64)."""
    bits = rows[:, 12:14].contiguous().view(torch.int32).long()
    rank = torch.zeros_like(bits[:, 0])
    for c, k in _RANK.items():
        rank = torch.where(bits[:, 0] == c, k, rank)
    return (rank << 32) | bits[:, 1]


def _leaf_pairs(ray, start, count):
    """Expand (ray, leaf) pairs into (ray, row) pairs."""
    pr = ray.repeat_interleave(count)
    first = torch.cumsum(count, 0) - count
    pos = torch.arange(pr.numel(), device=ray.device)
    return pr, start.repeat_interleave(count) + pos - first.repeat_interleave(
        count)


def _walk(pt: PacketTables, o, d, inv, keep, fold):
    """Visit the tree for rays (o, d): expand the frontier of (ray, node)
    pairs one level at a time into (ray, child) pairs, keeping a pair
    while ``keep(ray, tn, tf)`` holds for the child's box, and hand each
    kept leaf's (ray, row) pairs and their t to ``fold(ray, row, t)``
    before the next level is culled."""
    box, ref, count = _children(pt)
    ray = torch.arange(o.shape[0], device=o.device)
    node = torch.zeros_like(ray)
    while ray.numel():
        pair, child = torch.nonzero(count[node] >= 0, as_tuple=True)
        ray, node = ray[pair], node[pair]
        tn, tf = _slab(box[node, :, child], o[ray], inv[ray])
        k = keep(ray, tn, tf)
        ray, node, child = ray[k], node[k], child[k]
        first, n_rows = ref[node, child], count[node, child]
        leaf = n_rows > 0
        if bool(leaf.any()):
            pr, row = _leaf_pairs(ray[leaf], first[leaf], n_rows[leaf])
            fold(pr, row, _row_t(pt.rows[row], o[pr], d[pr], inv[pr]))
        ray, node = ray[~leaf], first[~leaf]


def _closest_chunk(pt: PacketTables, o, d):
    R = o.shape[0]
    inv = intersect._safe_inv(d)
    best_t = torch.full((R,), C.BIG, dtype=o.dtype, device=o.device)
    none = torch.iinfo(torch.int64).max
    best_k = torch.full((R,), none, dtype=torch.int64, device=o.device)
    keys = _row_key(pt.rows)

    def offer(ray, t, key):
        nonlocal best_t, best_k
        hit = t < C.BIG
        ray, t, key = ray[hit], t[hit], key[hit]
        t_min = torch.full_like(best_t, C.BIG).scatter_reduce(
            0, ray, t, "amin")
        at = t == t_min[ray]
        k_min = torch.full_like(best_k, none).scatter_reduce(
            0, ray[at], key[at], "amin")
        better = (t_min < best_t) | ((t_min == best_t) & (k_min < best_k))
        best_t = torch.where(better, t_min, best_t)
        best_k = torch.where(better, k_min, best_k)

    n_pl = pt.planes.shape[0]
    if n_pl:
        ray = torch.arange(R, device=o.device).repeat_interleave(n_pl)
        row = torch.arange(n_pl, device=o.device).repeat(R)
        offer(ray, _row_t(pt.planes[row], o[ray], d[ray], inv[ray]),
              _row_key(pt.planes)[row])
    _walk(pt, o, d, inv,
          lambda ray, tn, tf: (tn <= tf) & (tf >= 0.0) & (tn <= best_t[ray]),
          lambda ray, row, t: offer(ray, t, keys[row]))
    obj = (best_k & 0xFFFFFFFF).to(torch.int32)
    return best_t, torch.where(best_t >= C.BIG, -1, obj)


def closest_hit_plain(pt: PacketTables, o, d, dead=None):
    """(t [R], obj_id [R] int32, -1 on a miss) of rays (o, d) [R, 3].
    ``dead`` [R] bool slots are not traced and read (BIG, -1)."""
    if dead is not None:
        live = torch.nonzero(~dead).squeeze(1)
        t = o.new_full((o.shape[0],), C.BIG)
        obj = torch.full((o.shape[0],), -1, dtype=torch.int32,
                         device=o.device)
        t[live], obj[live] = closest_hit_plain(pt, o[live], d[live])
        return t, obj
    parts = [_closest_chunk(pt, o[s:s + _CHUNK], d[s:s + _CHUNK])
             for s in range(0, o.shape[0], _CHUNK)]
    if not parts:
        return o.new_zeros((0,)), torch.zeros(0, dtype=torch.int32,
                                              device=o.device)
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _any_chunk(pt: PacketTables, o, d, max_t, dead):
    R = o.shape[0]
    inv = intersect._safe_inv(d)
    occ = (dead.clone() if dead is not None
           else torch.zeros(R, dtype=torch.bool, device=o.device))

    def mark(ray, row, t):
        occ[ray[t < max_t]] = True

    n_pl = pt.planes.shape[0]
    if n_pl:
        ray = torch.arange(R, device=o.device).repeat_interleave(n_pl)
        row = torch.arange(n_pl, device=o.device).repeat(R)
        mark(ray, row, _row_t(pt.planes[row], o[ray], d[ray], inv[ray]))
    _walk(pt, o, d, inv,
          lambda ray, tn, tf: ((tn <= tf) & (tf >= 0.0) & (tn < max_t)
                               & ~occ[ray]),
          mark)
    return occ


def any_hit_plain(pt: PacketTables, o, d, max_t: float, dead=None):
    """[R] bool: does any primitive hit rays (o, d) at t < max_t? ``dead``
    lanes [R] bool report occluded without a walk."""
    return torch.cat([
        _any_chunk(pt, o[s:s + _CHUNK], d[s:s + _CHUNK], max_t,
                   None if dead is None else dead[s:s + _CHUNK])
        for s in range(0, o.shape[0], _CHUNK)]
        or [torch.zeros(0, dtype=torch.bool, device=o.device)])


# ---------------------------------------------------------------------------
# dispatch: the plain version on CPU tensors, the kernel on CUDA tensors.
# The walk is discrete: it reads the rays detached (JAX stop_gradients them,
# accel/packets.py:959-960 there), and its answers carry no gradient; the
# shading re-derives t differentiably from the winner (intersect.per_ray_t).


def packet_closest_hit(pt: PacketTables, rays: Rays, dead=None):
    """Closest hit of ``rays`` through the tree and the planes: (t [R],
    obj_id [R] int32), obj_id -1 on a miss. ``dead`` [R] bool marks slots
    the caller masks downstream: they are not traced and read (BIG, -1)."""
    o = rays.origin.detach().contiguous()
    d = rays.direction.detach().contiguous()
    if o.device.type == "cpu":
        return closest_hit_plain(pt, o, d, dead)
    from ..kernels import bvh_closest

    return bvh_closest(pt, o, d, dead)


def packet_any_hit(pt: PacketTables, rays: Rays, max_t: float, dead=None):
    """Occlusion [R] bool of segments ``rays`` (origin + t·direction, t <
    max_t). ``dead`` [R] bool marks lanes the caller masks downstream: they
    report occluded without a walk."""
    o = rays.origin.detach().contiguous()
    d = rays.direction.detach().contiguous()
    if o.device.type == "cpu":
        return any_hit_plain(pt, o, d, float(max_t), dead)
    from ..kernels import bvh_any

    return bvh_any(pt, o, d, float(max_t), dead)


def packet_any_hit_multi(pt: PacketTables, origin, dirs, max_t: float,
                         dead=None):
    """L occlusion queries per ray that share ``origin`` [R, 3]: ``dirs``
    a sequence of L [R, 3] segment vectors, ``dead`` None or L [R] bool
    masks. [L, R] bool, equal to L ``packet_any_hit`` calls; one kernel
    launch on CUDA tensors."""
    o = origin.detach().contiguous()
    dirs = [dv.detach() for dv in dirs]
    if o.device.type == "cpu":
        return torch.stack([
            any_hit_plain(pt, o, dv.contiguous(), float(max_t),
                          None if dead is None else dead[i])
            for i, dv in enumerate(dirs)])
    from ..kernels import bvh_any_multi

    return bvh_any_multi(pt, o, torch.stack(dirs),
                         float(max_t),
                         None if dead is None else torch.stack(list(dead)))
