"""The Whitted megakernel: the whole depth-D recursion tree of every ray in
one CUDA kernel (``csrc/whitted_megakernel.cu``), with its plain PyTorch
version beside it.

One kernel replaces two TPU kernels of the JAX package that compute the same
function and differ only in how the scene arrives:

  * ``u_4a_2s_p3d_raytracer_template2_tpu/models/whitted_megakernel.py``
    (``_build_kernel``): the scene baked in as immediates;
  * ``u_4a_2s_p3d_raytracer_template2_tpu/models/whitted_streamed.py``
    (``_build_streamed_kernel``): the scene read from SMEM tables.

Here the scene arrives as the streamed kernel's tables (``scene_tables``:
``[N·24]`` primitive+material rows in tri, sphere, plane, box order, each 12
floats of geometry and 11 of material padded to 12, so the kernel reads a
row as six 16-byte loads; ``[L·6]`` lights; ``[3]`` background), so one
build serves every scene. The plain
version is the sweep engine (models/whitted.py) over a scene rebuilt from the
same tables (``reconstruct_scene``), then clamped: the split of
``whitted_streamed.py:389-395``.

Distribution mode reads the sample plan of models/samples.py: the primary
rays of each subpixel are made in PyTorch (jitter, thin lens, shutter
time), and the kernel and its plain version read the same ``[n_rows, R]``
stream rows (the raw draws of the jittered light offsets and the
fuzzy-reflection perturbations, which each turns into values itself). A
miss reads the cubemap in the kernel, from device memory, in place of the
JAX kernel's deferred-sky epilogue. ``render_tile`` runs the anti-aliasing
loop of models/whitted.render_samples with one launch a subpixel (16 a frame
at spp 4): a subpixel's launch already holds 262,144 rays at 512², two
blocks per SM-slot and more, so a loop inside the kernel would buy no
occupancy, and each launch reads only its own subpixel's rows.

``trace_rays_megakernel`` dispatches on the device of its tensors: CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
There is no fallback from one to the other. A scene or config outside the
kernel's envelope (``supports``) never reaches it: models/whitted
.render_tile renders it through the wavefront engine, as the JAX package
does (``whitted.py:564-575`` there).

Gradients: ``WhittedTrace`` is the counterpart of the JAX kernel's
``custom_vjp`` (``whitted_streamed.py:399-427``): its forward launches the
kernel on detached copies of the tables and rays, and its backward runs
autograd through the plain version on the saved inputs, with the same
stream rows and sky. ``trace_rays_megakernel`` routes through it when a
CUDA input requires grad, so a train step on the megakernel engine launches
the kernel once a subpixel forward and never in the backward.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import constants as C
from ..core.types import (
    Camera,
    Lights,
    Materials,
    Primitives,
    RenderConfig,
    Rays,
    Scene,
    clamp01,
    filled,
)
from ..ops import intersect
from .samples import stream_layout

MAX_PRIMS = 256      # the JAX megakernels' unroll ceiling, kept as the envelope
MAX_DEPTH = 8        # deepest tree the kernel is instantiated for
# 12 params + diff(3) spec(3) kd ks shine transmit ior + a pad: six float4,
# which the kernel reads as 16-byte loads
TBL_W = 24


class StaticShape(NamedTuple):
    """The integers the kernel takes besides the tables: everything about a
    scene's structure, none of its values."""

    n_tri: int
    n_sph: int
    n_pl: int
    n_box: int
    n_lights: int
    has_refl: bool
    has_refr: bool

    @property
    def n(self) -> int:
        return self.n_tri + self.n_sph + self.n_pl + self.n_box


def shape_of(scene: Scene) -> StaticShape:
    p = scene.prims
    return StaticShape(n_tri=p.n_tri, n_sph=p.n_sph, n_pl=p.n_pl,
                       n_box=p.n_box, n_lights=scene.n_lights,
                       has_refl=bool(scene.has_reflective),
                       has_refr=bool(scene.has_transmissive))


def supports(scene: Scene, cfg: RenderConfig) -> bool:
    """Whether the kernel serves the scene and config: one to MAX_PRIMS
    primitives (JAX ``whitted_streamed.supports``) and depth MAX_DEPTH.
    ``engine="megakernel"`` renders anything else through the wavefront
    engine (models/whitted.engine_of)."""
    return 0 < scene.n_objects <= MAX_PRIMS and cfg.max_depth <= MAX_DEPTH


def check_supported(scene: Scene, cfg: RenderConfig) -> None:
    """Raise for a scene or config the kernel does not serve."""
    if scene.n_objects < 1 or cfg.max_depth < 1:
        raise ValueError(
            f"the megakernel needs a primitive and max_depth >= 1; got "
            f"{scene.n_objects} primitives, max_depth {cfg.max_depth}")
    if not supports(scene, cfg):
        raise NotImplementedError(
            f"{scene.n_objects} primitives at max_depth {cfg.max_depth}: the "
            f"megakernel serves at most {MAX_PRIMS} primitives and depth "
            f"{MAX_DEPTH}; render_tile takes such a scene or config to the "
            "wavefront engine")


def scene_tables(scene: Scene):
    """``[N*24]`` / ``[L*6]`` / ``[3]`` f32 views of the scene
    (``whitted_streamed.py:124-158``), in the type-grouped order so
    cross-type closest-hit ties break as in the sweep. Packed on the first
    call and kept in ``scene.cache``: a frame only launches. A scene whose
    tensors require grad (a train step's) is packed anew on every call,
    with torch ops, so the tables carry the step's graph: cached, a second
    render would backward through a freed graph or keep stale leaves."""
    tables = scene.cache.get("megakernel_tables")
    if tables is None:
        tables = _pack_tables(scene)
        if not _requires_grad(scene):
            scene.cache["megakernel_tables"] = tables
    return tables


def _requires_grad(scene: Scene) -> bool:
    """Whether a tensor the tables are packed from requires grad."""
    p = scene.prims
    sources = ((p.tri_p, p.sph_p, p.pl_p, p.box_p, scene.bg_color,
                scene.lights.position, scene.lights.color)
               + tuple(getattr(scene.materials, f.name)
                       for f in dataclasses.fields(scene.materials)))
    return any(t.requires_grad for t in sources)


def _pack_tables(scene: Scene):
    p = scene.prims
    m = scene.materials

    def mat_block(ids):
        mi = p.mat_id[ids.clamp(min=0).long()].long()
        return torch.cat([
            m.diff_color[mi], m.spec_color[mi], m.kd[mi][:, None],
            m.ks[mi][:, None], m.shine[mi][:, None],
            m.transmit[mi][:, None], m.ior[mi][:, None]], dim=-1)

    segs = []
    for tp, ids, n in ((p.tri_p, p.tri_ids, p.n_tri),
                       (p.sph_p, p.sph_ids, p.n_sph),
                       (p.pl_p, p.pl_ids, p.n_pl),
                       (p.box_p, p.box_ids, p.n_box)):
        if n == 0:
            continue
        pr = torch.nn.functional.pad(tp[:n], (0, 12 - tp.shape[1]))
        mat = torch.nn.functional.pad(mat_block(ids[:n]), (0, TBL_W - 23))
        segs.append(torch.cat([pr, mat], dim=-1))
    tbl = torch.cat(segs, dim=0).reshape(-1)
    L = max(1, scene.n_lights)
    lt = torch.cat([scene.lights.position[:L], scene.lights.color[:L]],
                   dim=-1).reshape(-1)
    return tbl, lt, scene.bg_color.to(torch.float32)


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def reconstruct_scene(shape: StaticShape, tbl, lt, bg, skybox=None) -> Scene:
    """Grouped-order Scene rebuilt from the tables
    (``whitted_streamed.py:165-234``): brute traversal, one material row per
    primitive with mat_id = arange, a placeholder camera, and the cubemap
    ``skybox`` if given."""
    dev = tbl.device
    N = shape.n
    tblm = tbl.reshape(N, TBL_W)
    params12 = tblm[:, :12]
    Npad = _round_up(N, 8)
    params = torch.nn.functional.pad(params12, (0, 0, 0, Npad - N))
    # filled on the device: the Function's backward rebuilds this scene
    # inside a captured train step (utils/graphs.py), which cannot copy
    # from host memory
    ptype = torch.cat([
        torch.full((n,), code, dtype=torch.int32, device=dev)
        for code, n in ((C.TRIANGLE, shape.n_tri), (C.SPHERE, shape.n_sph),
                        (C.PLANE, shape.n_pl), (C.AABOX, shape.n_box),
                        (C.INVALID, Npad - N))])
    mat_id = torch.arange(Npad, dtype=torch.int32, device=dev) % max(N, 1)

    def view(start, n, width):
        k = _round_up(max(n, 1), 8)
        rows = torch.zeros((k, width), dtype=tbl.dtype, device=dev)
        gi = torch.full((k,), -1, dtype=torch.int32, device=dev)
        if n:
            rows[:n] = params12[start:start + n, :width]
            gi[:n] = torch.arange(start, start + n, dtype=torch.int32,
                                  device=dev)
        return rows, gi

    starts = [0, shape.n_tri, shape.n_tri + shape.n_sph,
              shape.n_tri + shape.n_sph + shape.n_pl]
    tri_p, tri_ids = view(starts[0], shape.n_tri, 12)
    sph_p, sph_ids = view(starts[1], shape.n_sph, 4)
    pl_p, pl_ids = view(starts[2], shape.n_pl, 4)
    box_p, box_ids = view(starts[3], shape.n_box, 6)

    mats = Materials(
        diff_color=tblm[:, 12:15], spec_color=tblm[:, 15:18],
        kd=tblm[:, 18], ks=tblm[:, 19], shine=tblm[:, 20],
        transmit=tblm[:, 21], ior=tblm[:, 22])
    Lp = lt.reshape(-1, 6)
    lights = Lights(position=Lp[:, 0:3], color=Lp[:, 3:6])

    def z(x):
        return filled(x, torch.float32, dev)

    def s(x):
        return torch.full((), x, dtype=torch.float32, device=dev)

    cam = Camera(eye=z([0.0, 0.0, 0.0]), u=z([1.0, 0.0, 0.0]),
                 v=z([0.0, 1.0, 0.0]), n=z([0.0, 0.0, 1.0]), w=s(1.0),
                 h=s(1.0), plane_dist=s(1.0), focal_ratio=s(1.0),
                 aperture=s(0.0), time0=s(0.0), time1=s(0.0),
                 res_x=1, res_y=1)
    prims = Primitives(
        params=params, ptype=ptype, mat_id=mat_id,
        tri_p=tri_p, tri_ids=tri_ids, sph_p=sph_p, sph_ids=sph_ids,
        pl_p=pl_p, pl_ids=pl_ids, box_p=box_p, box_ids=box_ids,
        n_tri=shape.n_tri, n_sph=shape.n_sph, n_pl=shape.n_pl,
        n_box=shape.n_box)
    return Scene(prims=prims, materials=mats, lights=lights, camera=cam,
                 bg_color=bg, skybox=skybox, has_skybox=skybox is not None,
                 accel_type=C.ACCEL_NONE, spp=0, n_objects=N,
                 n_lights=shape.n_lights, has_reflective=shape.has_refl,
                 has_transmissive=shape.has_refr,
                 brute=intersect.brute_tables(prims))


def layout_of(shape: StaticShape, cfg: RenderConfig):
    """The stream rows' layout (models/samples.py) for this shape."""
    return stream_layout(shape.has_refl, shape.has_refr, shape.n_lights, cfg)


def trace_rays_plain(shape: StaticShape, tbl, lt, bg, o, d,
                     cfg: RenderConfig, rows=None, skybox=None,
                     offsets=None) -> torch.Tensor:
    """The kernel's plain version: clamped [R,3] color of rays (o, d), with
    the stream rows ``rows`` [n_rows, R] of the subpixel ``offsets`` (i, j)
    and the cubemap ``skybox`` (read on a miss under ``use_skybox``)."""
    from .whitted import trace_rays

    scene = reconstruct_scene(shape, tbl, lt, bg, skybox)
    return clamp01(trace_rays(scene, Rays.make(o, d), cfg, rows, offsets))


def sky_of(scene: Scene, cfg: RenderConfig):
    """The cubemap a miss reads, or None (flat background)."""
    return scene.skybox if (cfg.use_skybox and scene.has_skybox) else None


class WhittedTrace(torch.autograd.Function):
    """The Whitted kernel with a gradient: ``apply(tbl, lt, bg, o, d,
    shape, cfg, rows, sky, offsets)`` is the clamped [R,3] color of
    ``trace_rays_plain``, differentiable in ``tbl``, ``lt``, ``bg``, ``o``
    and ``d``; the stream rows, the sky and the offsets get no gradient
    (JAX gives them zero or float0 cotangents).

    Forward: the CUDA kernel on detached contiguous copies (on CPU tensors
    the plain version, without autograd). Backward: autograd through
    ``trace_rays_plain`` on the saved inputs, with the same rows and sky:
    no kernel launch. The JAX ``custom_vjp`` split
    (``whitted_streamed.py:399-427``)."""

    @staticmethod
    def forward(ctx, tbl, lt, bg, o, d, shape, cfg, rows, sky, offsets):
        ctx.save_for_backward(tbl, lt, bg, o, d)
        ctx.rest = (shape, cfg, rows, sky, offsets)
        args = [t.detach().contiguous() for t in (tbl, lt, bg, o, d)]
        if o.device.type == "cpu":
            return trace_rays_plain(shape, *args, cfg, rows, sky, offsets)
        from ..kernels import whitted_megakernel

        return whitted_megakernel(*args, shape, cfg, rows, sky, offsets)

    @staticmethod
    def backward(ctx, grad):
        shape, cfg, rows, sky, offsets = ctx.rest
        needs = ctx.needs_input_grad[:5]  # tbl, lt, bg, o, d
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            out = trace_rays_plain(shape, *ins, cfg, rows, sky, offsets)
            got = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], grad,
                allow_unused=True))
        # None: no gradient (an input the render does not reach)
        return (*(next(got) if n else None for n in needs),
                None, None, None, None, None)


def trace_rays_megakernel(scene: Scene, rays: Rays, cfg: RenderConfig,
                          rows=None, offsets=None) -> torch.Tensor:
    """Clamped [R,3] color of primary rays through the whole Whitted tree,
    with the stream rows ``rows`` of the config's sample plan and the
    subpixel indices ``offsets``.

    CPU tensors run the plain version (autograd through it where an input
    requires grad); CUDA tensors launch the CUDA kernel or raise, through
    ``WhittedTrace`` when an input requires grad.
    """
    from .whitted import check_config

    check_config(cfg)
    check_supported(scene, cfg)
    shape = shape_of(scene)
    tbl, lt, bg = scene_tables(scene)
    o, d = rays.origin, rays.direction
    sky = sky_of(scene, cfg)
    if o.device.type == "cpu":
        return trace_rays_plain(shape, tbl, lt, bg, o, d, cfg, rows, sky,
                                offsets)
    if o.device.type != "cuda":
        raise NotImplementedError(
            f"the megakernel runs on CUDA or CPU tensors, not {o.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (tbl, lt, bg, o, d)):
        return WhittedTrace.apply(tbl, lt, bg, o, d, shape, cfg, rows, sky,
                                  offsets)
    from ..kernels import whitted_megakernel

    return whitted_megakernel(tbl.detach(), lt.detach(), bg.detach(),
                              o.detach().contiguous(),
                              d.detach().contiguous(), shape, cfg, rows,
                              sky, offsets)


def render_tile(scene: Scene, px: torch.Tensor, py: torch.Tensor,
                cfg: RenderConfig, generator=None,
                draws=None) -> torch.Tensor:
    """models/whitted.render_tile on the megakernel: the same subpixel loop
    and draws, one ``trace_rays_megakernel`` a subpixel."""
    from .whitted import render_samples

    check_supported(scene, cfg)
    return render_samples(scene, px, py, cfg, trace_rays_megakernel,
                          generator, draws)


def make_render_tile(scene: Scene, cfg: RenderConfig):
    """``tile(px, py, generator=None)`` -> clamped [R,3] colors of
    ``scene``'s pixels on the megakernel engine (JAX ``make_render_tile``,
    ``whitted_megakernel.py:828-909``): every subpixel of a call in one
    program, as JAX's ``lax.scan`` over them, so a distribution frame's
    draws (``models/samples.draw_subpixel``) and its 16 launches are one
    CUDA graph replay on CUDA tensors (``whitted.render_tile_compiled``);
    on CPU tensors the eager ``render_tile``."""
    from .whitted import check_config, render_tile_compiled

    check_config(cfg)
    check_supported(scene, cfg)
    cfg = dataclasses.replace(cfg, engine="megakernel")

    def tile(px, py, generator=None):
        return render_tile_compiled(scene, px, py, cfg, generator)

    return tile
