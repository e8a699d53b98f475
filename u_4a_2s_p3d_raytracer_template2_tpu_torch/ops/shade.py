"""Whitted shading math (the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/ops/shade.py``): Blinn-Phong direct
lighting, reflection and refraction directions, Fresnel weights.

Reference semantics: processLight (main.cpp:471-526) and the recursive
rayTracing body (main.cpp:530-721) as per-ray batch functions. The quirk
switches are documented in ``RenderConfig``. Fuzzy reflection and the skybox
are not ported yet.
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
    i = mat_id.long()
    return MatView(
        materials.diff_color[i], materials.kd[i], materials.spec_color[i],
        materials.ks[i], materials.shine[i], materials.transmit[i],
        materials.ior[i],
    )


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
