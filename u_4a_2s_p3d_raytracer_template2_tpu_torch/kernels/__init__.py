"""Wrappers of the hand-written CUDA kernels.

Each wrapper checks its tensors, launches its kernel on PyTorch's current
stream through the ctypes entry point, raises if the launch returned a CUDA
error, and counts its launches in a plain integer attribute (``.launches``),
so a run can show that it went through the kernel. Nothing here runs on the
CPU: the dispatch between a kernel and its plain version lives beside the
plain version (models/, accel/packets.py, ops/intersect.py); the device
probes' plain versions are in tools/, and the probes have no dispatch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..models.pathtracer import N_UNIFORMS
from ..models.pt_megakernel import ROW_W
from ..models.whitted_megakernel import layout_of
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
    if name == "bvh_closest_launch":
        fn.argtypes = ([ctypes.c_void_p]                         # stream
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]  # o, d, R
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int]  # tables
                       + [ctypes.c_void_p] * 3)          # t, id, counts
    else:
        fn.argtypes = ([ctypes.c_void_p]                         # stream
                       + [ctypes.c_void_p] * 2                   # o, dirs
                       + [ctypes.c_int] * 2 + [ctypes.c_float]   # L, R, max_t
                       + [ctypes.c_void_p]                       # dead
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int]  # tables
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
            f"{name} requires grad: the kernels are forward only (the "
            "Whitted kernel's autograd.Function is ROADMAP.md queue 1, "
            "item 11)")


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
    _check("tbl", tbl, dev, shape.n * 23)
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


# per-ray work counters of the BVH walk: node box tests, then triangle,
# sphere, plane and box tests
WORK_COUNTS = 5


def _bvh_args(tables, o, d, counts):
    """Check the BVH walk's tables, rays and counter buffer; returns the
    device, the ray count and the table arguments of the C entry points."""
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
    for name, t in (("nodes", tables.nodes), ("rows", tables.rows),
                    ("planes", tables.planes)):
        if t.dim() != 2 or t.shape[1] not in (8, 16) or t.data_ptr() % 16:
            raise ValueError(f"{name}: want 16-byte aligned rows of 8 or 16 "
                             f"floats, got {tuple(t.shape)}")
    if counts is not None:
        _check("counts", counts, dev, WORK_COUNTS * R, torch.int32)
    return dev, R, [tables.nodes.data_ptr(), tables.rows.data_ptr(),
                    tables.planes.data_ptr(), tables.planes.shape[0]]


def bvh_closest(tables, o, d, counts=None):
    """(t [R], obj_id [R] int32, -1 on a miss) of rays (o, d) [R,3] through
    the BVH walk on the card (csrc/bvh_walk.cu). ``tables`` is
    ``accel.packets.PacketTables``; ``counts``, an optional int32
    [R, WORK_COUNTS], receives each ray's node box, triangle, sphere, plane
    and box tests (the main path passes None)."""
    dev, R, tbl = _bvh_args(tables, o, d, counts)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    obj = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return t, obj
    with torch.cuda.device(dev):
        rc = _bvh_entry("bvh_closest_launch")(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            d.data_ptr(), R, *tbl, t.data_ptr(), obj.data_ptr(),
            None if counts is None else counts.data_ptr())
    if rc != 0:
        raise RuntimeError(f"bvh_closest launch failed: CUDA error {rc}")
    bvh_closest.launches += 1
    return t, obj


bvh_closest.launches = 0


def _bvh_any(tables, o, dirs, max_t, dead, counts):
    dev, R, tbl = _bvh_args(tables, o, dirs, counts)
    L = dirs.shape[0]
    if dead is not None:
        _check("dead", dead, dev, L * R, torch.bool)
    out = torch.empty((L, R), dtype=torch.bool, device=dev)
    if R == 0 or L == 0:
        return out, False
    with torch.cuda.device(dev):
        rc = _bvh_entry("bvh_any_launch")(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            dirs.data_ptr(), L, R, max_t,
            None if dead is None else dead.data_ptr(), *tbl, out.data_ptr(),
            None if counts is None else counts.data_ptr())
    if rc != 0:
        raise RuntimeError(f"bvh_any launch failed: CUDA error {rc}")
    return out, True


def bvh_any(tables, o, d, max_t: float, dead=None, counts=None):
    """Occlusion [R] bool of segments o + t·d, t < ``max_t``, through the
    BVH walk on the card; ``dead`` [R] bool lanes report occluded without a
    walk. ``counts`` as for ``bvh_closest``."""
    out, launched = _bvh_any(tables, o, d[None], max_t,
                             None if dead is None else dead[None], counts)
    bvh_any.launches += launched
    return out[0]


bvh_any.launches = 0


def bvh_any_multi(tables, o, dirs, max_t: float, dead=None, counts=None):
    """Occlusion [L, R] bool of L segment sets ``dirs`` [L, R, 3] that share
    the origins ``o`` [R, 3], in one launch: equal to L ``bvh_any`` calls.
    ``dead`` None or [L, R] bool. ``counts`` sums each ray's work over the L
    sets."""
    if dirs.dim() != 3:
        raise ValueError(f"dirs: want [L, R, 3], got {tuple(dirs.shape)}")
    out, launched = _bvh_any(tables, o, dirs, max_t, dead, counts)
    bvh_any_multi.launches += launched
    return out


bvh_any_multi.launches = 0


# per-ray work counters of the brute-force kernels, tests by where they
# ended (csrc/prim_tests.cuh): triangle tests at the det, u and v gates and
# with their t, then sphere tests at the discriminant and with their roots
BRUTE_COUNTS = 6


@functools.cache
def _brute_entry(name: str):
    fn = getattr(load("brute_intersect"), name)
    fn.restype = ctypes.c_int
    tables = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int]
    if name == "brute_closest_launch":
        fn.argtypes = ([ctypes.c_void_p]                         # stream
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]  # o, d, R
                       + tables            # sph, sph_id, n_sph, tri, n_tri
                       + [ctypes.c_void_p] * 3)          # t, id, counts
    else:
        fn.argtypes = ([ctypes.c_void_p]                         # stream
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]  # o, d, R
                       + [ctypes.c_float, ctypes.c_void_p]       # max_t, dead
                       + tables
                       + [ctypes.c_void_p] * 2)          # out, counts
    return fn


def _brute_args(tables, o, d, counts):
    """Check the brute-force tables, rays and counter buffer; returns the
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
    _check("sph", tables.sph, dev, 4 * tables.n_sph)
    _check("sph_ids", tables.sph_ids, dev, tables.n_sph, torch.int32)
    _check("tri", tables.tri, dev, 12 * tables.n_tri)
    # the kernels read the rows as float4
    for name, t in (("sph", tables.sph), ("tri", tables.tri)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: want 16-byte aligned rows")
    if counts is not None:
        _check("counts", counts, dev, BRUTE_COUNTS * R, torch.int32)
    return dev, R, [tables.sph.data_ptr(), tables.sph_ids.data_ptr(),
                    tables.n_sph, tables.tri.data_ptr(), tables.n_tri]


def brute_closest(tables, o, d, counts=None):
    """(t [R], obj_id [R] int32, -1 on a miss) of rays (o, d) [R,3] against
    every triangle and sphere of ``tables`` (``ops.intersect.BruteTables``)
    on the card (csrc/brute_intersect.cu). ``counts``, an optional int32
    [R, BRUTE_COUNTS], receives each ray's triangle and sphere tests by
    where they ended (the main path passes None)."""
    dev, R, tbl = _brute_args(tables, o, d, counts)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    obj = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return t, obj
    with torch.cuda.device(dev):
        rc = _brute_entry("brute_closest_launch")(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            d.data_ptr(), R, *tbl, t.data_ptr(), obj.data_ptr(),
            None if counts is None else counts.data_ptr())
    if rc != 0:
        raise RuntimeError(f"brute_closest launch failed: CUDA error {rc}")
    brute_closest.launches += 1
    return t, obj


brute_closest.launches = 0


def brute_any(tables, o, d, max_t: float, dead=None, counts=None):
    """Occlusion [R] bool of segments o + t·d, t < ``max_t``, against every
    triangle and sphere of ``tables`` on the card; ``dead`` [R] bool lanes
    report occluded without a test. ``counts`` as for ``brute_closest``,
    counting the tests each ray ran before its first occluder."""
    dev, R, tbl = _brute_args(tables, o, d, counts)
    if dead is not None:
        _check("dead", dead, dev, R, torch.bool)
    out = torch.empty(R, dtype=torch.bool, device=dev)
    if R == 0:
        return out
    with torch.cuda.device(dev):
        rc = _brute_entry("brute_any_launch")(
            torch.cuda.current_stream(dev).cuda_stream, o.data_ptr(),
            d.data_ptr(), R, max_t,
            None if dead is None else dead.data_ptr(), *tbl, out.data_ptr(),
            None if counts is None else counts.data_ptr())
    if rc != 0:
        raise RuntimeError(f"brute_any launch failed: CUDA error {rc}")
    brute_any.launches += 1
    return out


brute_any.launches = 0


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
