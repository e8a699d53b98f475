"""Wrappers of the hand-written CUDA kernels.

Each wrapper checks its tensors, launches its kernel on PyTorch's current
stream through the ctypes entry point, raises if the launch returned a CUDA
error, and counts its launches in a plain integer attribute (``.launches``),
so a run can show that it went through the kernel; a launch that a CUDA
graph's capture records counts there too. A graph's replays run the kernel
without its wrapper: they are counted on the device, from the profiler's
kernel events named ``.device_kernel`` (``utils/profiling.device_launches``).
No kernel runs on the CPU (the per-ray kernels' tables are packed on any
device: ``perray_rows`` and ``perray_grid_table`` with PyTorch ops,
``perray_bvh_table`` on the host): the dispatch between a kernel
and its plain version lives beside the plain version (models/,
accel/packets.py, accel/traverse.py, ops/intersect.py); the device
probes' plain versions are in tools/, and the probes have no dispatch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import GridArrays
from ..models.pathtracer import N_UNIFORMS
from ..models.pt_megakernel import ROW_W
from ..models.whitted_megakernel import TBL_W, layout_of
from .build import load

_FRESNEL = {"schlick": 0, "reference_schlick": 1, "reference_exact": 2}
_REFRACTION = {"reference": 0, "physical": 1}


@functools.cache
def _whitted_entry():
    fn = load("whitted_megakernel").whitted_megakernel_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p]                         # stream
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int]  # o, d, out, R
                   + [ctypes.c_void_p] * 3                   # tbl, lt, bg
                   + [ctypes.c_int] * 12
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2  # rows, jit, fuzzy
                   + [ctypes.c_float] * 3 + [ctypes.c_int]   # rough, i, j, spp
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3)  # sky, h, w, f32
    return fn


@functools.cache
def _pt_entry():
    fn = load("pt_megakernel").pt_megakernel_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p]                         # stream
                   + [ctypes.c_void_p] * 5                   # o, d, t, uni, out
                   + [ctypes.c_int] * 2                      # R, n_bounces
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2  # tbl, n_sph, n_tri
                   + [ctypes.c_void_p] + [ctypes.c_int]      # lt, n_lights
                   + [ctypes.c_int] * 2)                     # rr, shadow_len1
    return fn


@functools.cache
def _bvh_entry(name: str):
    fn = getattr(load("bvh_walk"), name)
    fn.restype = ctypes.c_int
    tables = ([ctypes.c_void_p, ctypes.c_int]                  # nodes, width
              + [ctypes.c_void_p] * 2 + [ctypes.c_int])  # rows, planes, Kp
    if name == "bvh_closest_launch":
        fn.argtypes = ([ctypes.c_void_p]                         # stream
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]  # o, d, R
                       + [ctypes.c_void_p]                       # dead
                       + tables
                       + [ctypes.c_void_p] * 3)          # t, id, counts
    else:
        fn.argtypes = ([ctypes.c_void_p]                         # stream
                       + [ctypes.c_void_p] * 2                   # o, dirs
                       + [ctypes.c_int] * 2 + [ctypes.c_float]   # L, R, max_t
                       + [ctypes.c_void_p]                       # dead
                       + tables
                       + [ctypes.c_void_p] * 2)          # out, counts
    return fn


def _check(name: str, t: torch.Tensor, device: torch.device, numel=None,
           dtype=torch.float32):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: want {numel} elements, got {t.numel()}")
    if t.requires_grad:
        raise NotImplementedError(
            f"{name} requires grad: the kernels are forward only. Call "
            "them through their dispatchers, which detach what a discrete "
            "query reads (accel/packets.py, ops/intersect.py), or the "
            "Whitted kernel through models/whitted_megakernel."
            "trace_rays_megakernel, whose autograd.Function takes the "
            "gradient through the plain version")


def _check_aligned(name: str, t: torch.Tensor):
    """The megakernels read their table rows as float4."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: want a 16-byte aligned tensor")


def whitted_megakernel(tbl, lt, bg, o, d, shape, cfg, rows=None,
                       sky=None, offsets=None) -> torch.Tensor:
    """Clamped [R,3] color of rays (o, d) [R,3] through the whole Whitted
    tree, on the card (csrc/whitted_megakernel.cu).

    ``tbl``/``lt``/``bg`` are ``models.whitted_megakernel.scene_tables``;
    ``shape`` its ``StaticShape``; ``cfg`` a ``RenderConfig`` that passes
    ``models.whitted.check_config``, max_depth in 1..8. ``rows``: the
    ``[n_rows, R]`` raw stream rows of the config's layout
    (``models.whitted_megakernel.layout_of``), when it has any, and
    ``offsets`` the subpixel's (i, j) indices under AA. ``sky``: the
    ``[6, H, W, 3]`` u8 or f32 cubemap a miss reads, or None for the flat
    background.
    """
    if o.device.type != "cuda":
        raise ValueError(f"whitted_megakernel runs on CUDA tensors, not "
                         f"{o.device}")
    dev = o.device
    R = o.shape[0]
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"rays: want o, d of shape [R,3], got "
                         f"{tuple(o.shape)} and {tuple(d.shape)}")
    _check("o", o, dev)
    _check("d", d, dev)
    _check("tbl", tbl, dev, shape.n * TBL_W)
    _check_aligned("tbl", tbl)
    _check("lt", lt, dev, 6 * max(1, shape.n_lights))
    _check("bg", bg, dev, 3)
    layout = layout_of(shape, cfg)
    rows_ptr = None
    if layout.n_rows:
        if rows is None:
            raise ValueError(f"this config reads {layout.n_rows} stream rows "
                             "a ray; got none")
        _check("rows", rows, dev, layout.n_rows * R)
        rows_ptr = rows.data_ptr()
    si, sj = offsets if offsets is not None else (0.0, 0.0)
    sky_ptr, sky_h, sky_w, sky_f32 = None, 0, 0, 0
    if sky is not None:
        if sky.dim() != 4 or sky.shape[0] != 6 or sky.shape[3] != 3:
            raise ValueError(f"sky: want [6, H, W, 3], got "
                             f"{tuple(sky.shape)}")
        if sky.dtype not in (torch.uint8, torch.float32):
            raise ValueError(f"sky: want uint8 or float32, got {sky.dtype}")
        _check("sky", sky, dev, dtype=sky.dtype)
        sky_ptr, sky_h, sky_w = sky.data_ptr(), sky.shape[1], sky.shape[2]
        sky_f32 = int(sky.dtype == torch.float32)
    out = torch.empty_like(o)
    with torch.cuda.device(dev):  # restores the caller's device after
        rc = _whitted_entry()(
            torch.cuda.current_stream(dev).cuda_stream,
            o.data_ptr(), d.data_ptr(), out.data_ptr(), R,
            tbl.data_ptr(), lt.data_ptr(), bg.data_ptr(),
            shape.n_tri, shape.n_sph, shape.n_pl, shape.n_box,
            shape.n_lights, int(shape.has_refl), int(shape.has_refr),
            cfg.max_depth, _FRESNEL[cfg.fresnel_mode],
            _REFRACTION[cfg.refraction_mode], int(cfg.shadow_unbounded),
            int(cfg.soft_shadow and not cfg.anti_aliasing),
            rows_ptr, int(layout.soft_jit), int(layout.fuzzy),
            float(cfg.roughness), float(si), float(sj), max(cfg.spp, 1),
            sky_ptr, sky_h, sky_w, sky_f32)
    if rc != 0:
        raise RuntimeError(f"whitted_megakernel launch failed: CUDA error "
                           f"{rc}")
    whitted_megakernel.launches += 1
    return out


whitted_megakernel.launches = 0
whitted_megakernel.device_kernel = "whitted_kernel"


def pt_megakernel(tables, o, d, time, uni, cfg) -> torch.Tensor:
    """[R,3] linear color of paths (o, d [R,3], time [R]) through the whole
    bounce loop of the GLSL path tracer, on the card
    (csrc/pt_megakernel.cu).

    ``tables`` is ``models.pt_megakernel.pt_tables``; ``uni`` the
    ``[B, 11, R]`` uniforms of ``models.pathtracer.draw_uniforms`` (B bounces
    at most); ``cfg`` a ``PTConfig`` (its russian_roulette and
    reference_shadow_len1 are read).
    """
    if o.device.type != "cuda":
        raise ValueError(f"pt_megakernel runs on CUDA tensors, not "
                         f"{o.device}")
    dev = o.device
    R = o.shape[0]
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"rays: want o, d of shape [R,3], got "
                         f"{tuple(o.shape)} and {tuple(d.shape)}")
    if uni.dim() != 3 or uni.shape[1:] != (N_UNIFORMS, R):
        raise ValueError(f"uni: want shape [B, {N_UNIFORMS}, {R}], got "
                         f"{tuple(uni.shape)}")
    _check("o", o, dev)
    _check("d", d, dev)
    _check("time", time, dev, R)
    _check("uni", uni, dev)
    _check("tbl", tables.tbl, dev, (tables.n_sph + tables.n_tri) * ROW_W)
    _check_aligned("tbl", tables.tbl)
    _check("lt", tables.lt, dev, 6 * max(1, tables.n_lights))
    out = torch.empty_like(o)
    with torch.cuda.device(dev):  # restores the caller's device after
        rc = _pt_entry()(
            torch.cuda.current_stream(dev).cuda_stream,
            o.data_ptr(), d.data_ptr(), time.data_ptr(), uni.data_ptr(),
            out.data_ptr(), R, uni.shape[0],
            tables.tbl.data_ptr(), tables.n_sph, tables.n_tri,
            tables.lt.data_ptr(), tables.n_lights,
            int(cfg.russian_roulette), int(cfg.reference_shadow_len1))
    if rc != 0:
        raise RuntimeError(f"pt_megakernel launch failed: CUDA error {rc}")
    pt_megakernel.launches += 1
    return out


pt_megakernel.launches = 0
pt_megakernel.device_kernel = "pt_kernel"


# per-ray work counters of the BVH walk: child box tests; triangle tests
# ended at the det, u and v gates and with their t; sphere tests ended at
# the discriminant and with their roots (csrc/prim_tests.cuh's stages, in
# ops/intersect.BRUTE_STAGES' order); plane and box tests
WORK_COUNTS = 9


def _bvh_args(tables, o, d, counts):
    """Check the BVH walk's tables, rays and counter buffer; returns the
    device, the ray count and the table arguments of the C entry points
    (the launch refuses nodes of another width than its kernel's)."""
    if o.device.type != "cuda":
        raise ValueError(f"the BVH walk runs on CUDA tensors, not {o.device}")
    dev = o.device
    R = o.shape[0]
    if o.dim() != 2 or o.shape[1] != 3 or d.shape[-2:] != o.shape:
        raise ValueError(f"rays: want o [R,3] and directions [..., R, 3], "
                         f"got {tuple(o.shape)} and {tuple(d.shape)}")
    _check("o", o, dev)
    _check("d", d, dev)
    _check("nodes", tables.nodes, dev)
    _check("rows", tables.rows, dev)
    _check("planes", tables.planes, dev)
    # the kernel reads nodes and rows as float4
    for name, t, w in (("nodes", tables.nodes, 8 * tables.width),
                       ("rows", tables.rows, 16),
                       ("planes", tables.planes, 16)):
        if t.dim() != 2 or t.shape[1] != w or t.data_ptr() % 16:
            raise ValueError(f"{name}: want 16-byte aligned rows of {w} "
                             f"floats, got {tuple(t.shape)}")
    if counts is not None:
        _check("counts", counts, dev, WORK_COUNTS * R, torch.int32)
    return dev, R, [tables.nodes.data_ptr(), tables.width,
                    tables.rows.data_ptr(), tables.planes.data_ptr(),
                    tables.planes.shape[0]]


def bvh_closest(tables, o, d, dead=None, counts=None, out=None):
    """(t [R], obj_id [R] int32, -1 on a miss) of rays (o, d) [R,3] through
    the BVH walk on the card (csrc/bvh_walk.cu). ``tables`` is
    ``accel.packets.PacketTables``. ``dead`` [R] bool slots are not traced
    and read (BIG, -1); the live ones are packed inside the launch, and the
    host never waits for their count. ``counts``, an optional int32
    [R, WORK_COUNTS] of zeros, receives each ray's child box tests,
    triangle and sphere tests by where they ended, plane and box tests (the
    main path passes None). ``out``: the (t, obj_id) tensors to write
    into, else new ones; the card's checks pass them filled with other
    values, so that a slot the kernel leaves unwritten shows."""
    dev, R, tbl = _bvh_args(tables, o, d, counts)
    if dead is not None:
        _check("dead", dead, dev, R, torch.bool)
    if out is None:
        out = (torch.empty(R, dtype=torch.float32, device=dev),
               torch.empty(R, dtype=torch.int32, device=dev))
    t, obj = out
    _check("t", t, dev, R)
    _check("obj_id", obj, dev, R, torch.int32)
    if R == 0:
        return t, obj
    with torch.cuda.device(dev):
        rc = _bvh_entry("bvh_closest_launch")(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            d.data_ptr(), R, _ptr(dead), *tbl, t.data_ptr(), obj.data_ptr(),
            _ptr(counts))
    if rc != 0:
        raise RuntimeError(f"bvh_closest launch failed: CUDA error {rc}")
    bvh_closest.launches += 1
    return t, obj


bvh_closest.launches = 0
bvh_closest.device_kernel = "closest_kernel"


def _bvh_any(tables, o, dirs, max_t, dead, counts, out):
    dev, R, tbl = _bvh_args(tables, o, dirs, counts)
    L = dirs.shape[0]
    if dead is not None:
        _check("dead", dead, dev, L * R, torch.bool)
    if out is None:
        out = torch.empty((L, R), dtype=torch.bool, device=dev)
    _check("out", out, dev, L * R, torch.bool)
    if R == 0 or L == 0:
        return out, False
    with torch.cuda.device(dev):
        rc = _bvh_entry("bvh_any_launch")(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            dirs.data_ptr(), L, R, max_t, _ptr(dead), *tbl, out.data_ptr(),
            _ptr(counts))
    if rc != 0:
        raise RuntimeError(f"bvh_any launch failed: CUDA error {rc}")
    return out, True


def bvh_any(tables, o, d, max_t: float, dead=None, counts=None, out=None):
    """Occlusion [R] bool of segments o + t·d, t < ``max_t``, through the
    BVH walk on the card; ``dead`` [R] bool lanes report occluded without a
    walk, and the live ones are packed inside the launch. ``counts`` and
    ``out`` (an [R] bool tensor) as for ``bvh_closest``."""
    got, launched = _bvh_any(tables, o, d[None], max_t,
                             None if dead is None else dead[None], counts,
                             None if out is None else out.view(1, -1))
    bvh_any.launches += launched
    return got[0]


bvh_any.launches = 0
bvh_any.device_kernel = "any_kernel"


def bvh_any_multi(tables, o, dirs, max_t: float, dead=None, counts=None,
                  out=None):
    """Occlusion [L, R] bool of L segment sets ``dirs`` [L, R, 3] that share
    the origins ``o`` [R, 3], in one launch: equal to L ``bvh_any`` calls.
    ``dead`` None or [L, R] bool; the live (set, ray) pairs are packed
    inside the launch. ``counts`` sums each ray's work over the L sets;
    ``out`` an [L, R] bool tensor."""
    if dirs.dim() != 3:
        raise ValueError(f"dirs: want [L, R, 3], got {tuple(dirs.shape)}")
    got, launched = _bvh_any(tables, o, dirs, max_t, dead, counts, out)
    bvh_any_multi.launches += launched
    return got


bvh_any_multi.launches = 0
bvh_any_multi.device_kernel = "any_kernel"


@functools.cache
def _brute_entry(name: str):
    fn = getattr(load("brute_intersect"), name)
    if name == "brute_scratch_bytes":
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int] * 3
        return fn
    fn.restype = ctypes.c_int
    tables = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int]
    if name == "brute_closest_launch":
        fn.argtypes = ([ctypes.c_void_p]                         # stream
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]  # o, d, R
                       + [ctypes.c_void_p]                       # dead
                       + tables            # sph, sph_id, n_sph, tri, n_tri
                       + [ctypes.c_void_p] * 3)          # t, id, scratch
    else:
        fn.argtypes = ([ctypes.c_void_p]                         # stream
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]  # o, d, R
                       + [ctypes.c_float, ctypes.c_void_p]       # max_t, dead
                       + tables
                       + [ctypes.c_void_p] * 2)          # out, scratch
    return fn


def _brute_args(tables, o, d, dead):
    """Check the brute-force tables, rays and dead mask; returns the
    device, the ray count and the table arguments of the C entry points."""
    if o.device.type != "cuda":
        raise ValueError(f"the brute-force kernels run on CUDA tensors, not "
                         f"{o.device}")
    dev = o.device
    R = o.shape[0]
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"rays: want o, d of shape [R,3], got "
                         f"{tuple(o.shape)} and {tuple(d.shape)}")
    _check("o", o, dev)
    _check("d", d, dev)
    if dead is not None:
        _check("dead", dead, dev, R, torch.bool)
    _check("sph", tables.sph, dev, 4 * tables.n_sph)
    _check("sph_ids", tables.sph_ids, dev, tables.n_sph, torch.int32)
    _check("tri", tables.tri, dev, 12 * tables.n_tri)
    # the kernels read the rows as float4
    for name, t in (("sph", tables.sph), ("tri", tables.tri)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: want 16-byte aligned rows")
    return dev, R, [tables.sph.data_ptr(), tables.sph_ids.data_ptr(),
                    tables.n_sph, tables.tri.data_ptr(), tables.n_tri]


def _brute_scratch(R, dev, closest: bool, dead):
    """The launch's scratch (per-ray keys, and with a dead mask the
    compaction's indices and counts), or None where it needs none."""
    n = _brute_entry("brute_scratch_bytes")(R, int(closest),
                                            int(dead is not None))
    return torch.empty(n, dtype=torch.uint8, device=dev) if n else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def brute_closest(tables, o, d, dead=None, out=None):
    """(t [R], obj_id [R] int32, -1 on a miss) of rays (o, d) [R,3] against
    every triangle and sphere of ``tables`` (``ops.intersect.BruteTables``)
    on the card (csrc/brute_intersect.cu). ``dead`` [R] bool slots are not
    traced and read (BIG, -1); the live ones are packed on the device
    before the sweep, and the host never waits for their count. ``out``:
    the (t, obj_id) tensors to write into, else new ones; the card's
    checks pass them filled with other values, so that a slot the kernel
    leaves unwritten shows."""
    dev, R, tbl = _brute_args(tables, o, d, dead)
    if out is None:
        out = (torch.empty(R, dtype=torch.float32, device=dev),
               torch.empty(R, dtype=torch.int32, device=dev))
    t, obj = out
    _check("t", t, dev, R)
    _check("obj_id", obj, dev, R, torch.int32)
    if R == 0:
        return t, obj
    scratch = _brute_scratch(R, dev, True, dead)
    with torch.cuda.device(dev):
        rc = _brute_entry("brute_closest_launch")(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            d.data_ptr(), R, _ptr(dead), *tbl, t.data_ptr(), obj.data_ptr(),
            _ptr(scratch))
    if rc != 0:
        raise RuntimeError(f"brute_closest launch failed: CUDA error {rc}")
    brute_closest.launches += 1
    return t, obj


brute_closest.launches = 0
brute_closest.device_kernel = "brute_closest_sweep"


def brute_any(tables, o, d, max_t: float, dead=None, out=None):
    """Occlusion [R] bool of segments o + t·d, t < ``max_t``, against every
    triangle and sphere of ``tables`` on the card; ``dead`` [R] bool slots
    report occluded without a test, and the live ones are packed on the
    device before the sweep. ``out`` as for ``brute_closest``: the [R]
    bool tensor to write into."""
    dev, R, tbl = _brute_args(tables, o, d, dead)
    if out is None:
        out = torch.empty(R, dtype=torch.bool, device=dev)
    _check("out", out, dev, R, torch.bool)
    if R == 0:
        return out
    scratch = _brute_scratch(R, dev, False, dead)
    with torch.cuda.device(dev):
        rc = _brute_entry("brute_any_launch")(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            d.data_ptr(), R, max_t, _ptr(dead), *tbl, out.data_ptr(),
            _ptr(scratch))
    if rc != 0:
        raise RuntimeError(f"brute_any launch failed: CUDA error {rc}")
    brute_any.launches += 1
    return out


brute_any.launches = 0
brute_any.device_kernel = "brute_any_sweep"



# ---------------------------------------------------------------------------
# the reference's per-ray traversals (csrc/perray_traverse.cu): the median
# BVH's stack walk and the grid DDA over accel/bvh.py's and accel/grid.py's
# tables, packed once a tree or grid for the kernels (perray_bvh_table,
# perray_grid_table), and the primitives' table, packed once a Primitives
# object (_prims_rows: perray_bvh_rows in the tree's order, perray_rows by
# object id)


def perray_rows(prims) -> torch.Tensor:
    """The per-ray traversals' primitive table [N, 16] f32, row i object i
    in the BVH walk's row layout (accel/packets.py): the 12 parameters of
    ``prims.params``, then its type code and id as int32 bits, and 2 pad
    floats. Made on the primitives' device from their tensors (detached),
    with no host copy, so a compiled frame packs it from its inputs on
    every replay: three device ops."""
    params = prims.params.detach()
    n = params.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=params.device)
    return torch.cat([params, prims.ptype.view(torch.float32)[:, None],
                      ids.view(torch.float32)[:, None],
                      params.new_zeros((n, 2))], dim=1)


class PerrayBvhTable(NamedTuple):
    """The median BVH as csrc/perray_traverse.cu walks it."""

    # [1 + inner nodes, 16] f32, one 64 B record a row: record 0 holds the
    # root's box (columns 0-5) and reference (int32 bits in columns 12 and
    # 14); record r >= 1 the inner node node_ids[r], breadth first: its
    # left and right child's boxes (0-5, 6-11), then as int32 bits each
    # child's index (12, 13: an inner child's record, a leaf's first row)
    # and meta (14, 15: -1 for an inner child, a leaf's object count)
    nodes: torch.Tensor
    # [order + planes] int32: the object of each row of the walk's
    # primitive table (perray_bvh_rows): the tree's order, so a leaf's
    # objects are consecutive rows, then the planes' ids; -1 pads
    objects: torch.Tensor
    # [order + planes] int64: objects with its pads at 0, the rows'
    # gather; and [order + planes, 3] f32: each row's tail after its type
    # code, its object id as int32 bits and two zero pads
    rows_at: torch.Tensor
    rows_tail: torch.Tensor
    # [1 + inner nodes] int64, on the host: the BvhArrays node of each
    # record (record 0: the root, node 0)
    node_ids: torch.Tensor
    n_order: int


def _packed(accel, pack):
    """``pack(accel)`` made once for the tree or grid ``accel`` and kept on
    it, outside its dataclass fields (not part of its value, and
    ``dataclasses.replace`` starts anew; the arrays are not edited in place
    once built, core/types.py). A compiled frame's capture keeps the
    scene's tree and grid whole (utils/graphs.py), so its warm-up packs
    them and the capture and replays find them packed."""
    table = accel.__dict__.get("_perray_table")
    if table is None:
        table = pack(accel)
        object.__setattr__(accel, "_perray_table", table)
    return table


def perray_bvh_table(bvh) -> PerrayBvhTable:
    """The median BVH ``bvh`` (``core.types.BvhArrays``) packed for the
    kernels, once a tree (``_packed``; the pack reads the tree on the
    host). Raises ValueError where a child or a leaf's first row is out of
    range."""
    return _packed(bvh, _pack_bvh)


def _pack_bvh(bvh) -> PerrayBvhTable:
    leaf = bvh.leaf.cpu().numpy().astype(bool)
    index = bvh.index.cpu().numpy().astype(np.int64)
    n_objs = bvh.n_objs.cpu().numpy().astype(np.int64)
    lo = bvh.bbox_min.cpu().numpy().astype(np.float32)
    hi = bvh.bbox_max.cpu().numpy().astype(np.float32)
    K = leaf.shape[0]
    # the inner nodes breadth first from the root, each once
    seen = np.zeros(K, bool)
    seen[0] = True
    levels = []
    frontier = np.zeros(0 if leaf[0] else 1, np.int64)
    while frontier.size:
        levels.append(frontier)
        left = index[frontier]
        kids = np.stack([left, np.minimum(left + 1, K - 1)], 1).reshape(-1)
        if ((kids < 0) | (kids >= K)).any():
            raise ValueError("median BVH: a child index out of range")
        _, first = np.unique(kids, return_index=True)
        fresh = kids[np.sort(first)]
        fresh = fresh[~seen[fresh]]
        seen[fresh] = True
        frontier = fresh[~leaf[fresh]]
    node_ids = np.concatenate([np.zeros(1, np.int64), *levels])
    leaves = seen & leaf
    if ((index[leaves] < 0) | (index[leaves] >= 1 << 28)).any():
        raise ValueError("median BVH: a leaf's first object out of range")
    rec = np.zeros(K, np.int64)
    rec[node_ids[1:]] = np.arange(1, node_ids.size)

    def ref(ch):  # (index, meta) of the children ch
        return (np.where(leaf[ch], index[ch], rec[ch]),
                np.where(leaf[ch], np.maximum(n_objs[ch], 0), -1))

    nodes = np.zeros((node_ids.size, 16), np.float32)
    bits = nodes.view(np.int32)
    nodes[0, 0:3], nodes[0, 3:6] = lo[0], hi[0]
    (bits[0, 12],), (bits[0, 14],) = ref(np.zeros(1, np.int64))
    bits[0, 15] = -1
    left = index[node_ids[1:]]
    right = np.minimum(left + 1, K - 1)
    nodes[1:, 0:3], nodes[1:, 3:6] = lo[left], hi[left]
    nodes[1:, 6:9], nodes[1:, 9:12] = lo[right], hi[right]
    bits[1:, 12], bits[1:, 14] = ref(left)
    bits[1:, 13], bits[1:, 15] = ref(right)
    dev = bvh.order.device
    objects = torch.cat([bvh.order, bvh.unbounded_ids]).to(torch.int32)
    tail = torch.zeros((objects.numel(), 3), device=dev)
    tail.view(torch.int32)[:, 0] = objects
    return PerrayBvhTable(
        nodes=torch.from_numpy(nodes).to(dev), objects=objects,
        rows_at=objects.clamp(min=0).long(), rows_tail=tail,
        node_ids=torch.from_numpy(node_ids), n_order=bvh.order.numel())


def perray_bvh_rows(bvh, prims) -> torch.Tensor:
    """The median BVH walk's primitive table: ``perray_rows``' layout in
    the tree's object order, then the planes (``perray_bvh_table(bvh)
    .objects``), a row's id -1 (a row no walk tests) where the object is
    a pad. Packed from the primitives like ``perray_rows``, with one
    gather: three device ops."""
    t = perray_bvh_table(bvh)
    return torch.cat([prims.params.detach()[t.rows_at],
                      prims.ptype[t.rows_at].view(torch.float32)[:, None],
                      t.rows_tail], dim=1)


def _prims_rows(prims, bvh=None) -> torch.Tensor:
    """The primitive table a per-ray kernel reads: ``perray_bvh_rows(bvh,
    prims)`` for the median BVH's walk, ``perray_rows(prims)`` for the
    DDA (``bvh`` None). Packed once a ``Primitives`` object and kept on it
    (outside its fields, as ``_packed`` keeps the tree's), so a frame's 12
    queries read one pack; a compiled frame's warm-up and capture rebuild
    the primitives (utils/graphs.py), so its graph packs once a replay,
    from its inputs. Primitives whose params require grad (a train step's)
    are packed on every call, as the megakernel's tables are
    (models/whitted_megakernel.scene_tables)."""
    def pack():
        return perray_rows(prims) if bvh is None else perray_bvh_rows(
            bvh, prims)

    if prims.params.requires_grad:
        return pack()
    kept = prims.__dict__.get("_perray_rows")
    if kept is None or kept[0] is not bvh:
        kept = (bvh, pack())
        object.__setattr__(prims, "_perray_rows", kept)
    return kept[1]


class PerrayGridTable(NamedTuple):
    """The uniform grid's items as csrc/perray_traverse.cu's DDA reads
    them."""

    # [cells, 4 * ceil(max_per_cell / 4)] int32: each cell's items in their
    # order in cell_items, -1 padded, read as int4
    items: torch.Tensor
    count: torch.Tensor  # [cells] int32: each cell's items


def perray_grid_table(grid) -> PerrayGridTable:
    """The grid ``grid`` (``core.types.GridArrays``) packed for the
    kernels, once a grid (``_packed``), on its device with no host read:
    each cell's items (its non-negative ``cell_items``, in order) and
    their count."""
    return _packed(grid, _pack_grid)


def _pack_grid(grid) -> PerrayGridTable:
    items = grid.cell_items
    n, m = items.shape
    valid = items >= 0
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    count = valid.sum(dim=1, dtype=torch.int32)
    slots = torch.arange(m, device=items.device)
    packed = torch.full((n, 4 * -(-max(m, 1) // 4)), -1, dtype=torch.int32,
                        device=items.device)
    packed[:, :m] = torch.where(slots < count[:, None],
                                items.gather(1, order), -1)
    return PerrayGridTable(packed, count)


@functools.cache
def _perray_entry(name: str):
    fn = getattr(load("perray_traverse"), name)
    fn.restype = ctypes.c_int
    head = ([ctypes.c_void_p]                          # stream
            + [ctypes.c_void_p] * 2 + [ctypes.c_int])  # o, d, R
    if name.endswith("any_launch"):
        head += [ctypes.c_float]                       # max_t
    if name == "grid_any_launch":
        head += [ctypes.c_int]                         # init_fail_occludes
    head += [ctypes.c_void_p]                          # dead
    if name.startswith("median_bvh"):
        # nodes, records; rows, order's rows, planes
        accel = [ctypes.c_void_p, ctypes.c_int]
        prims = [ctypes.c_void_p] + [ctypes.c_int] * 2
    else:
        # box min, max, items, count, nx, ny, nz, w4; rows, planes' ids, Kp
        accel = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        prims = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    out = ([ctypes.c_void_p] * 3 if name.endswith("closest_launch")
           else [ctypes.c_void_p] * 2)                 # t, id | occ; counts
    fn.argtypes = head + accel + prims + out
    return fn


def _perray_args(what, accel, prims, o, d, dead, counts):
    """Check a per-ray query's rays, dead mask, counter buffer and tables,
    and find its primitive table (``_prims_rows``: the tree's walk reads
    its rows in the tree's order, the DDA by object id); returns the
    device, the ray count, the table (held until the launch) and the C
    entry point's table arguments (the accelerator's, then the
    primitives')."""
    if o.device.type != "cuda":
        raise ValueError(f"the {what} runs on CUDA tensors, not {o.device}")
    dev = o.device
    R = o.shape[0]
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"rays: want o, d of shape [R,3], got "
                         f"{tuple(o.shape)} and {tuple(d.shape)}")
    _check("o", o, dev)
    _check("d", d, dev)
    if dead is not None:
        _check("dead", dead, dev, R, torch.bool)
    if counts is not None:
        _check("counts", counts, dev, WORK_COUNTS * R, torch.int32)
    if prims.params.device != dev or prims.ptype.device != dev:
        raise ValueError(f"the primitives: want them on {dev}, got "
                         f"{prims.params.device}")
    if prims.params.dim() != 2 or prims.params.shape[1] != 12:
        raise ValueError(f"the primitives: want [N, 12] params, got "
                         f"{tuple(prims.params.shape)}")
    _check("unbounded_ids", accel.unbounded_ids, dev, dtype=torch.int32)
    if isinstance(accel, GridArrays):
        _check("bbox_min", accel.bbox_min, dev, 3)
        _check("bbox_max", accel.bbox_max, dev, 3)
        if (accel.cell_items.dim() != 2 or accel.cell_items.shape[0]
                != accel.nx * accel.ny * accel.nz):
            raise ValueError(f"cell_items: want [nx*ny*nz, m], got "
                             f"{tuple(accel.cell_items.shape)}")
        _check("cell_items", accel.cell_items, dev, dtype=torch.int32)
        g = perray_grid_table(accel)
        _check_aligned("items", g.items)
        rows = _prims_rows(prims)
        _check_aligned("rows", rows)
        return dev, R, rows, [
            accel.bbox_min.data_ptr(), accel.bbox_max.data_ptr(),
            g.items.data_ptr(), g.count.data_ptr(), accel.nx, accel.ny,
            accel.nz, g.items.shape[1] // 4, rows.data_ptr(),
            accel.unbounded_ids.data_ptr(), accel.unbounded_ids.numel()]
    b = perray_bvh_table(accel)
    _check("nodes", b.nodes, dev)
    _check_aligned("nodes", b.nodes)
    rows = _prims_rows(prims, accel)
    _check_aligned("rows", rows)
    return dev, R, rows, [b.nodes.data_ptr(), b.nodes.shape[0],
                          rows.data_ptr(), b.n_order,
                          b.objects.numel() - b.n_order]


def _perray_closest(name, what, accel, prims, o, d, dead, counts, out):
    dev, R, rows, tbl = _perray_args(what, accel, prims, o, d, dead, counts)
    if out is None:
        out = (torch.empty(R, dtype=torch.float32, device=dev),
               torch.empty(R, dtype=torch.int32, device=dev))
    t, obj = out
    _check("t", t, dev, R)
    _check("obj_id", obj, dev, R, torch.int32)
    if R == 0:
        return out, False
    with torch.cuda.device(dev):
        rc = _perray_entry(name)(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            d.data_ptr(), R, _ptr(dead), *tbl, t.data_ptr(), obj.data_ptr(),
            _ptr(counts))
    del rows  # read by the launch, freed after it in stream order
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    return out, True


def _perray_any(name, what, accel, prims, o, d, max_t, flags, dead, counts,
                out):
    dev, R, rows, tbl = _perray_args(what, accel, prims, o, d, dead, counts)
    if out is None:
        out = torch.empty(R, dtype=torch.bool, device=dev)
    _check("out", out, dev, R, torch.bool)
    if R == 0:
        return out, False
    with torch.cuda.device(dev):
        rc = _perray_entry(name)(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            d.data_ptr(), R, float(max_t), *flags, _ptr(dead), *tbl,
            out.data_ptr(), _ptr(counts))
    del rows  # read by the launch, freed after it in stream order
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    return out, True


def perray_bvh_closest(bvh, prims, o, d, dead=None, counts=None,
                       out=None):
    """(t [R], obj_id [R] int32, -1 on a miss) of rays (o, d) [R,3] through
    the median BVH ``bvh`` (``core.types.BvhArrays``) and the planes beside
    it, on the card (csrc/perray_traverse.cu), the primitives ``prims``
    (``core.types.Primitives``) packed once (``perray_bvh_rows``,
    ``_prims_rows``).
    ``dead`` [R] bool slots are not traced and read (BIG, -1).
    ``counts``, an optional int32 [R, WORK_COUNTS] of zeros, receives each
    ray's node box tests and primitive tests (bvh_closest's columns);
    ``out`` the (t, obj_id) tensors to write into."""
    got, launched = _perray_closest("median_bvh_closest_launch",
                                    "median BVH walk", bvh, prims, o, d,
                                    dead, counts, out)
    perray_bvh_closest.launches += launched
    return got


perray_bvh_closest.launches = 0
perray_bvh_closest.device_kernel = "median_bvh_closest_kernel"


def perray_bvh_any(bvh, prims, o, d, max_t: float, dead=None, counts=None,
                   out=None):
    """Occlusion [R] bool of segments o + t·d, t < ``max_t``, through the
    median BVH (its walk stops at the first such hit) and the planes, on
    the card; ``dead`` [R] bool slots report occluded without a walk.
    ``counts`` and ``out`` (an [R] bool tensor) as for
    ``perray_bvh_closest``."""
    got, launched = _perray_any("median_bvh_any_launch", "median BVH walk",
                                bvh, prims, o, d, max_t, (), dead, counts,
                                out)
    perray_bvh_any.launches += launched
    return got


perray_bvh_any.launches = 0
perray_bvh_any.device_kernel = "median_bvh_any_kernel"


def grid_closest(grid, prims, o, d, dead=None, counts=None, out=None):
    """(t [R], obj_id [R] int32, -1 on a miss) of rays (o, d) [R,3] through
    the DDA of the uniform grid ``grid`` (``core.types.GridArrays``) and the
    planes beside it, on the card (csrc/perray_traverse.cu), the primitives
    packed once (``perray_rows``, ``_prims_rows``); ``dead``, ``counts``
    (column 0: the cells stepped through) and ``out`` as for
    ``perray_bvh_closest``."""
    got, launched = _perray_closest("grid_closest_launch", "grid DDA", grid,
                                    prims, o, d, dead, counts, out)
    grid_closest.launches += launched
    return got


grid_closest.launches = 0
grid_closest.device_kernel = "grid_closest_kernel"


def grid_any(grid, prims, o, d, max_t: float, dead=None,
             init_fail_occludes: bool = False, counts=None, out=None):
    """Occlusion [R] bool of segments o + t·d, t < ``max_t``, through the
    shadow DDA of ``grid`` (it stops at the first such object) and the
    planes, on the card. ``init_fail_occludes``: a ray whose grid entry
    fails is occluded (the reference's grid.cpp:326-328 quirk). ``dead``,
    ``counts`` and ``out`` as for ``perray_bvh_any``."""
    got, launched = _perray_any("grid_any_launch", "grid DDA", grid, prims,
                                o, d, max_t, (int(init_fail_occludes),),
                                dead, counts, out)
    grid_any.launches += launched
    return got


grid_any.launches = 0
grid_any.device_kernel = "grid_any_kernel"

# T1's instruction classes, in csrc/probes.cu's order
PROBE_OPS = ("fma", "cheap", "div", "rsqrt", "select")
# T3's stack placements: shared memory [level][thread], or a per-thread
# array as csrc/bvh_walk.cu keeps its stack
STACKS = ("shared", "local")


@functools.cache
def _probe_entry(name: str):
    fn = getattr(load("probes"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = {
        "op_rate_launch": [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                   ctypes.c_int,
                                                   ctypes.c_int],
        "fma_peak_launch": [ctypes.c_void_p] * 3 + [ctypes.c_longlong],
        "stack_walk_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                              + [ctypes.c_void_p, ctypes.c_int]
                              + [ctypes.c_void_p, ctypes.c_int]
                              + [ctypes.c_void_p, ctypes.c_int]),
    }[name]
    return fn


def _probe_device(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, not {t.device}")
    return t.device


def op_rate(x, op: str, k: int = 512) -> torch.Tensor:
    """T1 on the card (csrc/probes.cu): for each element of ``x`` (f32, any
    shape) a chain of ``k`` dependent steps of the class ``op`` (one of
    PROBE_OPS, tools/roofline_mount.py's step bodies), from acc = x with the
    factor a = x·1e-9 + 0.9999; returns acc. ``k`` a positive multiple of
    16."""
    dev = _probe_device("op_rate", x)
    _check("x", x, dev)
    if op not in PROBE_OPS:
        raise ValueError(f"op: want one of {PROBE_OPS}, got {op!r}")
    if k <= 0 or k % 16:
        raise ValueError(f"k: want a positive multiple of 16, got {k}")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = _probe_entry("op_rate_launch")(
            torch.cuda.current_stream(dev).cuda_stream, x.data_ptr(),
            out.data_ptr(), x.numel(), PROBE_OPS.index(op), k)
    if rc != 0:
        raise RuntimeError(f"op_rate launch failed: CUDA error {rc}")
    op_rate.launches += 1
    return out


op_rate.launches = 0
op_rate.device_kernel = "op_rate_kernel"


def fma_peak(x) -> torch.Tensor:
    """T2 on the card (csrc/probes.cu): for each element a of ``x`` (f32,
    any shape) four interleaved chains of 128 FMAs each
    (tools/device_validate.py:120-135); returns b + c + d + e."""
    dev = _probe_device("fma_peak", x)
    _check("x", x, dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = _probe_entry("fma_peak_launch")(
            torch.cuda.current_stream(dev).cuda_stream, x.data_ptr(),
            out.data_ptr(), x.numel())
    if rc != 0:
        raise RuntimeError(f"fma_peak launch failed: CUDA error {rc}")
    fma_peak.launches += 1
    return out


fma_peak.launches = 0
fma_peak.device_kernel = "fma_peak_kernel"


def stack_walk(nbox, nmeta, table, rays, stack: str = "shared"):
    """T3 on the card (csrc/probes.cu): [P, 128] f32, the min from 1e30 over
    the leaves of the tree ``nmeta`` ([2N] int32, node i an inner node with
    children a, a+1 or a leaf of chunk a: (a, is_leaf) at 2i, 2i+1) of
    (table[a, 0, l] + rays[p, 0]) + nbox[6·node]; nbox [6N] f32, table
    [C, 8, 128] f32, rays [P, 8] f32. ``stack`` places the walk's stack
    (STACKS). A malformed tree, or one deeper than the 64-entry stack, gives
    NaN."""
    dev = _probe_device("stack_walk", rays)
    if nmeta.dim() != 1 or nmeta.numel() % 2 or nmeta.numel() == 0:
        raise ValueError(f"nmeta: want [2N] int32, got {tuple(nmeta.shape)}")
    n_nodes = nmeta.numel() // 2
    _check("nmeta", nmeta, dev, 2 * n_nodes, torch.int32)
    _check("nbox", nbox, dev, 6 * n_nodes)
    _check("table", table, dev)
    _check("rays", rays, dev)
    if table.dim() != 3 or table.shape[1:] != (8, 128):
        raise ValueError(f"table: want [C, 8, 128], got {tuple(table.shape)}")
    if rays.dim() != 2 or rays.shape[1] != 8:
        raise ValueError(f"rays: want [P, 8], got {tuple(rays.shape)}")
    if stack not in STACKS:
        raise ValueError(f"stack: want one of {STACKS}, got {stack!r}")
    P = rays.shape[0]
    out = torch.empty((P, 128), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _probe_entry("stack_walk_launch")(
            torch.cuda.current_stream(dev).cuda_stream, nbox.data_ptr(),
            nmeta.data_ptr(), n_nodes, table.data_ptr(), table.shape[0],
            rays.data_ptr(), P, out.data_ptr(), int(stack == "shared"))
    if rc != 0:
        raise RuntimeError(f"stack_walk launch failed: CUDA error {rc}")
    stack_walk.launches += 1
    return out


stack_walk.launches = 0
stack_walk.device_kernel = "stack_walk_kernel"
