"""Wrappers of the hand-written CUDA kernels.

Each wrapper checks its tensors, launches its kernel on PyTorch's current
stream through the ctypes entry point, raises if the launch returned a CUDA
error, and counts its launches in a plain integer attribute (``.launches``),
so a run can show that it went through the kernel. Nothing here runs on the
CPU: the dispatch between a kernel and its plain version lives beside the
plain version (models/).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..models.pathtracer import N_UNIFORMS
from ..models.pt_megakernel import ROW_W
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
                   + [ctypes.c_int] * 12)
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


def _check(name: str, t: torch.Tensor, device: torch.device, numel=None):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous float32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: want {numel} elements, got {t.numel()}")
    if t.requires_grad:
        raise NotImplementedError(
            f"{name} requires grad: the kernels are forward only (the "
            "Whitted kernel's autograd.Function is ROADMAP.md queue 1, "
            "item 11)")


def whitted_megakernel(tbl, lt, bg, o, d, shape, cfg) -> torch.Tensor:
    """Clamped [R,3] color of rays (o, d) [R,3] through the whole Whitted
    tree, on the card (csrc/whitted_megakernel.cu).

    ``tbl``/``lt``/``bg`` are ``models.whitted_megakernel.scene_tables``;
    ``shape`` its ``StaticShape``; ``cfg`` a ``RenderConfig`` that passes
    ``models.whitted.check_config`` (no anti-aliasing, so ``soft_shadow``
    means the deterministic 4x4 grid) with max_depth in 1..8.
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
            int(cfg.soft_shadow))
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
