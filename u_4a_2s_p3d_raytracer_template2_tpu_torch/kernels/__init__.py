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


def _check(name: str, t: torch.Tensor, device: torch.device, numel=None):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous float32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: want {numel} elements, got {t.numel()}")
    if t.requires_grad:
        raise NotImplementedError(
            f"{name} requires grad: the kernel is forward only; its "
            "autograd.Function comes with the training slice (ROADMAP.md)")


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
