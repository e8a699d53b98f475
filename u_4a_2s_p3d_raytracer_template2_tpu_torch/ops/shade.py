"""Whitted shading math (the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/ops/shade.py``): Blinn-Phong direct
lighting, reflection and refraction directions, Fresnel weights.

Reference semantics: processLight (main.cpp:471-526) and the recursive
rayTracing body (main.cpp:530-721) as per-ray batch functions, the fuzzy
reflection of main.cpp:651-660 on drawn sphere samples, and the skybox's
nearest-texel cubemap lookup (scene.cpp:383-461). The quirk switches are
documented in ``RenderConfig``.

The JAX package's ``pack_skybox_u32`` and ``skybox_color_packed`` are not
ported: they pack a texel into one u32 because XLA's TPU gather costs by the
element. Here the cubemap stays raw u8, and the CUDA kernel reads a texel's
three bytes itself.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.types import Materials, dot, normalize


class MatView(NamedTuple):
    """Per-ray gathered material parameters."""

    diff_color: torch.Tensor  # [R,3]
    kd: torch.Tensor          # [R]
    spec_color: torch.Tensor  # [R,3]
    ks: torch.Tensor          # [R]
    shine: torch.Tensor       # [R]
    transmit: torch.Tensor    # [R]
    ior: torch.Tensor         # [R]


def gather_materials(materials: Materials, mat_id: torch.Tensor) -> MatView:
    """Each ray's material, by ``index_select`` (a cheap backward into the
    few material rows: ``ops/intersect.gather_prims``)."""
    i = mat_id.long()
    return MatView(*(getattr(materials, f).index_select(0, i)
                     for f in MatView._fields))


def blinn_phong(L_unnorm, lit_mask, light_color, mat: MatView, ray_dir,
                normal):
    """One light's contribution (main.cpp:513-525).

    ``lit_mask`` combines the N·L>0 gate (on unnormalized L, main.cpp:476)
    with the shadow test. The specular term carries the reference's
    hard-coded 0.4 scale (main.cpp:524); pow(0, 0) is 1 as in C.
    """
    Lh = normalize(L_unnorm)
    V = normalize(-ray_dir)
    H = normalize(Lh + V)
    ndl = dot(normal, Lh).clamp(min=0.0)
    vdn = dot(H, normal).clamp(min=0.0)
    vdn_safe = torch.where(vdn > 0.0, vdn, 1.0)
    spec_pow = torch.where(
        vdn > 0.0,
        torch.pow(vdn_safe, mat.shine),
        torch.where(mat.shine == 0.0, 1.0, 0.0),
    )
    diff = light_color * mat.diff_color * ndl[:, None]
    spec = light_color * mat.spec_color * spec_pow[:, None]
    contrib = diff * mat.kd[:, None] + spec * (mat.ks * 0.4)[:, None]
    return torch.where(lit_mask[:, None], contrib, 0.0)


def reflect_dir(d, n):
    """Mirror direction d - 2 n (d·n) (main.cpp:649); unit when d is unit."""
    return d - 2.0 * n * dot(d, n)[:, None]


def fuzzy_reflect_dir(refl, normal, roughness: float, sphere):
    """Fuzzy perturbation (main.cpp:651-660) by ``sphere`` [R,3], points
    inside the unit sphere (``ops/sampling.unit_sphere_from_uniforms`` of
    three draws): the perturbed direction where it stays in the normal's
    hemisphere, else the mirror ``refl``."""
    fuzz = normalize(refl + roughness * sphere)
    keep = dot(fuzz, normal) > 0.0
    return torch.where(keep[:, None], fuzz, refl)


class RefractOut(NamedTuple):
    direction: torch.Tensor    # [R,3]
    can_refract: torch.Tensor  # [R] bool (False on total internal reflection)
    cos_i: torch.Tensor        # [R]
    cos_t: torch.Tensor        # [R]
    new_ior: torch.Tensor      # [R]


def refract(d, normal_flipped, inside, ior_1, mat_ior, mode: str) -> RefractOut:
    """Refraction via the reference's tangent/normal decomposition
    (main.cpp:671-697).

    mode "reference" reproduces the shipped direction t̂·sinθt + n̂ exactly;
    mode "physical" is Snell's transmitted direction t̂·sinθt − n̂·cosθt.
    """
    V = -d
    nf = normal_flipped
    ndv = dot(nf, V)
    viewtangent = nf * ndv[:, None] - V
    # non-transmissive materials may carry ior=0 (mount_low's rock)
    mat_ior = torch.where(mat_ior > 0.0, mat_ior, 1.0)
    eta = torch.where(inside, ior_1, ior_1 / mat_ior)
    cos_i = ndv.abs()
    vt2 = (viewtangent * viewtangent).sum(-1)
    sin_t = eta * torch.sqrt(vt2.clamp(min=1e-24))
    insqrt = 1.0 - sin_t * sin_t
    can = insqrt > 0.0
    cos_t = torch.where(can, torch.sqrt(torch.where(can, insqrt, 1.0)), 0.0)
    t_hat = normalize(viewtangent)
    if mode == "reference":
        direction = t_hat * sin_t[:, None] + nf
    elif mode == "physical":
        direction = normalize(t_hat * sin_t[:, None] - nf * cos_t[:, None])
    else:
        raise ValueError(f"unknown refraction mode {mode!r}")
    new_ior = torch.where(inside, 1.0, mat_ior)
    return RefractOut(direction, can, cos_i, cos_t, new_ior)


def fresnel_kr(ro: RefractOut, ior_1, transmit, ks, mode: str):
    """Reflection weight KR (main.cpp:699-717).

    Non-transmissive materials: KR = Ks (main.cpp:716). Transmissive:
      "schlick"           — Schlick approx; KR=1 on TIR
      "reference_schlick" — Schlick approx; KR=0 on TIR (int-division bug)
      "reference_exact"   — KR=0 always (the dead branch at main.cpp:711)
    """
    if mode == "reference_exact":
        kr_t = torch.zeros_like(ior_1)
    elif mode in ("schlick", "reference_schlick"):
        r0 = ((ior_1 - ro.new_ior) / (ior_1 + ro.new_ior)) ** 2
        schlick = r0 + (1.0 - r0) * (1.0 - ro.cos_i) ** 5
        tir_kr = 1.0 if mode == "schlick" else 0.0
        kr_t = torch.where(ro.can_refract, schlick, tir_kr)
    else:
        raise ValueError(f"unknown fresnel mode {mode!r}")
    return torch.where(transmit != 0.0, kr_t, ks)


def cubemap_index(d: torch.Tensor, H: int, W: int):
    """(side, yp, xp) nearest-texel cubemap indices by dominant axis
    (scene.cpp:383-461). Face order RIGHT, LEFT, TOP, BOTTOM, FRONT, BACK
    with the reference's conventions: LEFT at X=+1, RIGHT at X=-1
    (scene.cpp:398). d: [R, 3], need not be normalized."""
    return cubemap_index_xyz(d[:, 0], d[:, 1], d[:, 2], H, W)


def cubemap_index_xyz(x, y, z, H: int, W: int):
    """``cubemap_index`` on three [R] direction planes."""
    ax, ay, az = x.abs(), y.abs(), z.abs()
    # dominant axis, z checked last with strict > (scene.cpp:396-408)
    use_x = ax > ay
    ma = torch.where(use_x, ax, ay)
    side = torch.where(use_x, torch.where(x >= 0, 1, 0),
                       torch.where(y >= 0, 2, 3))
    use_z = az > ma
    ma = torch.where(use_z, az, ma)
    side = torch.where(use_z, torch.where(z >= 0, 4, 5), side)

    pick = side.long()[:, None]
    sc = torch.stack([-z, z, -x, -x, -x, x], dim=-1).gather(-1, pick)[:, 0]
    tc = torch.stack([y, y, -z, z, y, y], dim=-1).gather(-1, pick)[:, 0]
    inv = 1.0 / ma.clamp(min=1e-20)
    s = (sc * inv + 1.0) * 0.5
    t = (tc * inv + 1.0) * 0.5
    # truncation toward zero, then clip
    xp = ((W - 1) * s).to(torch.int32).clamp(0, W - 1)
    yp = ((H - 1) * t).to(torch.int32).clamp(0, H - 1)
    return side.to(torch.int32), yp, xp


def skybox_texel_to_float(rgb: torch.Tensor) -> torch.Tensor:
    """u8 texel -> float color as the reference's u8tofloat (byte/255.99,
    maths.h); float cubemaps (synthetic test ones) pass through."""
    if not rgb.dtype.is_floating_point:
        return rgb.to(torch.float32) / 255.99
    return rgb


def skybox_color(skybox: torch.Tensor, d: torch.Tensor,
                 valid=None) -> torch.Tensor:
    """Cubemap nearest-texel lookup (scene.cpp:383-461). skybox: [6, H, W,
    3] uint8 or float32; d: [R, 3]. Lanes where ``valid`` [R] is False read
    texel 0 of face 0 (their color is discarded by the caller)."""
    side, yp, xp = cubemap_index(d, skybox.shape[1], skybox.shape[2])
    if valid is not None:
        side = torch.where(valid, side, 0)
        yp = torch.where(valid, yp, 0)
        xp = torch.where(valid, xp, 0)
    return skybox_texel_to_float(skybox[side.long(), yp.long(), xp.long()])
