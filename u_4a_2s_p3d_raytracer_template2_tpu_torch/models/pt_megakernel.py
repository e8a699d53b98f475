"""The path-tracer megakernel: the whole bounce loop of every path in one
CUDA kernel (``csrc/pt_megakernel.cu``), with its plain PyTorch version
beside it.

It replaces the TPU kernel of
``u_4a_2s_p3d_raytracer_template2_tpu/models/pt_megakernel.py``
(``_build_kernel``, launched by ``_trace_fn_cached``), which baked the world
into the kernel as immediates. Here the world arrives as operand tables
(``pt_tables``: ``[N·24]`` sphere rows then triangle rows, each its
geometry padded to 12 floats and its material, so the kernel reads a row as
six 16-byte loads, and ``[L·6]`` lights), packed once per scene and kept in
``PTScene.cache``, so one build serves every world within the ceilings.
Padding rows (radius-0 spheres, degenerate triangles) are dropped, as the
TPU kernel's ``_PTConsts`` drops them.

Random numbers are drawn outside the kernel (``pathtracer.draw_uniforms``),
so the kernel and its plain version (``trace_rays_plain``:
``ray_color_presampled`` over a scene rebuilt from the same tables) are
comparable draw for draw. ``trace_rays_megakernel`` dispatches on the device
of its tensors: CPU tensors take the plain version, CUDA tensors launch the
kernel or raise. There is no fallback from one to the other.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.types import Camera, Rays
from ..utils import graphs
from .pathtracer import (
    PTConfig,
    PTMaterials,
    PTScene,
    camera_rays,
    draw_uniforms,
    ray_color_presampled,
    render_frame,
)

# the JAX kernel's bake ceilings, kept as the envelope (pt_megakernel.py:66-68)
MAX_SPHERES = 256
MAX_TRIS = 16
MAX_LIGHTS = 8
# A row is three float4 of geometry and three of material, which the kernel
# reads as 16-byte loads: c0(3) c1(3) r t0 t1 | v0(3) e1(3) e2(3), padded
# to GEOM_W; then mtype albedo(3) spec(3) rough ref_idx refract(3).
ROW_W = 24
GEOM_W = 12


class PTTables(NamedTuple):
    """The world as the kernel reads it."""

    tbl: torch.Tensor  # [(n_sph + n_tri) * ROW_W] f32, spheres first
    lt: torch.Tensor   # [max(1, n_lights) * 6] f32: position, color
    n_sph: int
    n_tri: int
    n_lights: int


def pt_tables(scene: PTScene) -> PTTables:
    """The scene's tables, packed on the first call and kept in
    ``scene.cache``: a frame only launches."""
    tables = scene.cache.get("pt_tables")
    if tables is None:
        tables = scene.cache["pt_tables"] = _pack_tables(scene)
    return tables


def _pack_tables(scene: PTScene) -> PTTables:
    m = scene.materials

    def mat_block(ids):
        mi = ids.long()
        return torch.cat([
            m.mtype[mi].to(torch.float32)[:, None], m.albedo[mi],
            m.spec_color[mi], m.roughness[mi][:, None], m.ref_idx[mi][:, None],
            m.refract_color[mi]], dim=-1)

    def pad(geom):
        return torch.nn.functional.pad(geom, (0, GEOM_W - geom.shape[1]))

    sph = torch.nonzero(scene.sp_radius != 0.0)[:, 0]
    sph_rows = torch.cat([pad(torch.cat([
        scene.sp_center0[sph], scene.sp_center1[sph],
        scene.sp_radius[sph][:, None], scene.sp_time0[sph][:, None],
        scene.sp_time1[sph][:, None]], dim=-1)),
        mat_block(scene.sp_mat[sph])], dim=-1)
    area = torch.linalg.vector_norm(
        torch.linalg.cross(scene.tri_e1, scene.tri_e2), dim=-1)
    tri = torch.nonzero(area != 0.0)[:, 0]
    tri_rows = torch.cat([pad(torch.cat([
        scene.tri_v0[tri], scene.tri_e1[tri], scene.tri_e2[tri]], dim=-1)),
        mat_block(scene.tri_mat[tri])], dim=-1)
    n_lights = scene.light_pos.shape[0]
    lt = torch.cat([scene.light_pos, scene.light_color], dim=-1)
    if n_lights == 0:
        lt = lt.new_zeros((1, 6))
    return PTTables(
        tbl=torch.cat([sph_rows, tri_rows]).to(torch.float32).reshape(-1),
        lt=lt.to(torch.float32).reshape(-1).contiguous(),
        n_sph=int(sph.shape[0]), n_tri=int(tri.shape[0]), n_lights=n_lights)


def _fits(tables: PTTables) -> bool:
    return (tables.n_sph <= MAX_SPHERES and tables.n_tri <= MAX_TRIS
            and tables.n_lights <= MAX_LIGHTS)


def supports(scene: PTScene) -> bool:
    """Whether the world fits the kernel's ceilings (after dropping
    padding rows)."""
    return _fits(pt_tables(scene))


def _check_supported(tables: PTTables) -> None:
    if not _fits(tables):
        raise NotImplementedError(
            f"{tables.n_sph} spheres, {tables.n_tri} triangles, "
            f"{tables.n_lights} lights: the path-tracer kernel serves at most "
            f"{MAX_SPHERES}, {MAX_TRIS} and {MAX_LIGHTS}; use engine='plain'")


def scene_from_tables(tables: PTTables) -> PTScene:
    """The PTScene the tables describe: one material row per primitive
    (spheres, then triangles). An empty group gets one row that never hits
    (a radius-0 sphere, a degenerate triangle), since ``hit_world`` reduces
    over each group."""
    dev = tables.tbl.device
    rows = tables.tbl.reshape(-1, ROW_W)
    sph, tri = rows[:tables.n_sph], rows[tables.n_sph:]
    if tables.n_sph == 0:
        sph = rows.new_zeros((1, ROW_W))
    if tables.n_tri == 0:
        tri = rows.new_zeros((1, ROW_W))
    mat_rows = torch.cat([sph, tri])[:, GEOM_W:]
    ns = sph.shape[0]
    mats = PTMaterials(
        mtype=mat_rows[:, 0].to(torch.int32), albedo=mat_rows[:, 1:4],
        spec_color=mat_rows[:, 4:7], roughness=mat_rows[:, 7],
        ref_idx=mat_rows[:, 8], refract_color=mat_rows[:, 9:12],
        emissive=torch.zeros_like(mat_rows[:, 9:12]))
    lp = tables.lt.reshape(-1, 6)[:tables.n_lights]

    def ids(start, n):
        return torch.arange(start, start + n, dtype=torch.int32, device=dev)

    return PTScene(
        sp_center0=sph[:, 0:3], sp_center1=sph[:, 3:6], sp_radius=sph[:, 6],
        sp_time0=sph[:, 7], sp_time1=sph[:, 8], sp_mat=ids(0, ns),
        tri_v0=tri[:, 0:3], tri_e1=tri[:, 3:6], tri_e2=tri[:, 6:9],
        tri_mat=ids(ns, tri.shape[0]), materials=mats,
        light_pos=lp[:, 0:3], light_color=lp[:, 3:6])


def trace_rays_plain(tables: PTTables, o, d, time, uni,
                     cfg: PTConfig) -> torch.Tensor:
    """The kernel's plain version: [R,3] linear color of rays (o, d, time)
    [R,3], [R,3], [R] from the uniforms uni [B, 11, R]."""
    return ray_color_presampled(scene_from_tables(tables), cfg,
                                Rays(o, d, time), uni)


def trace_rays_megakernel(tables: PTTables, o, d, time, uni,
                          cfg: PTConfig) -> torch.Tensor:
    """[R,3] linear color of rays through the whole bounce loop.

    CPU tensors run the plain version; CUDA tensors launch the CUDA kernel
    or raise."""
    _check_supported(tables)
    if o.device.type == "cpu":
        return trace_rays_plain(tables, o, d, time, uni, cfg)
    if o.device.type != "cuda":
        raise NotImplementedError(
            f"the path-tracer kernel runs on CUDA or CPU tensors, not "
            f"{o.device}")
    from ..kernels import pt_megakernel

    return pt_megakernel(tables, o.contiguous(), d.contiguous(),
                         time.contiguous(), uni.contiguous(), cfg)


ENGINES = ("plain", "megakernel")


def render_frame_megakernel(tables: PTTables, cam: Camera, cfg: PTConfig,
                            generator: torch.Generator) -> torch.Tensor:
    """One 1-spp frame [H,W,3] (linear) through ``trace_rays_megakernel``,
    eagerly: the draws of ``pathtracer.render_frame`` (``camera_rays``,
    then ``[B, 11, R]`` uniforms) from ``generator``, one trace and the
    reshape (JAX ``make_render_frame``'s jitted frame,
    ``pt_megakernel.py:602``)."""
    rays = camera_rays(cam, generator)
    uni = draw_uniforms(generator, cfg.max_bounces, rays.origin.shape[0])
    col = trace_rays_megakernel(tables, rays.origin, rays.direction,
                                rays.time, uni, cfg)
    return col.reshape(cam.res_y, cam.res_x, 3)


def make_render_frame(scene: PTScene, cam: Camera, cfg: PTConfig,
                      engine: str = "megakernel"):
    """generator -> [H,W,3] linear 1-spp estimate.

    ``engine="plain"`` is ``pathtracer.render_frame``. ``"megakernel"``
    draws the frame's samples as it does and traces them with
    ``trace_rays_megakernel``, so one seed gives elementwise-comparable
    frames from both engines. On CUDA tensors either engine's frame is one
    compiled program (JAX jits both, ``models/pathtracer.py:447, 477``
    there): a replay of the CUDA graph of ``render_frame_megakernel``,
    captured at the first frame of its config, camera shape and tables, or
    of ``pathtracer.render_frame``, captured at the first frame of its
    config and the scene's and camera's shapes (``utils/graphs.py``), the
    camera (and the plain engine's scene) copied in and the generator
    advanced as the eager frame advances it; on CPU tensors the eager
    frame."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: want one of {ENGINES}")
    if engine == "plain":
        if not graphs.on_card(scene.device):
            return functools.partial(render_frame, scene, cam, cfg)

        def plain_frame(generator: torch.Generator) -> torch.Tensor:
            return graphs.CACHE.call(
                "pathtracer.frame",
                lambda s, c, g: render_frame(s, c, cfg, g), (scene, cam),
                generator, static=(cfg,))

        return plain_frame
    tables = pt_tables(scene)
    _check_supported(tables)
    if not graphs.on_card(scene.device):
        return functools.partial(render_frame_megakernel, tables, cam, cfg)

    def frame(generator: torch.Generator) -> torch.Tensor:
        # the tables are the graph's by identity: the closure holds them
        # while the graph lives, so their id is not reused in a key
        return graphs.CACHE.call(
            "pt_megakernel.frame",
            lambda c, g: render_frame_megakernel(tables, c, cfg, g),
            (cam,), generator, static=(cfg, id(tables)))

    return frame
