"""Stochastic sampling primitives; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/ops/sampling.py``.

Each sampler is a pure ``*_from_uniforms`` transform of raw U[0,1) draws
(the closed-form polar methods of common.glsl:71-89) plus a keyed wrapper that
draws those uniforms from an explicit ``torch.Generator`` on the generator's
device. The path-tracer kernel (csrc/pt_megakernel.cu) applies the same
transforms to uniforms drawn outside it, so kernel and plain version are
comparable draw for draw.

torch has no cube root: ``u.pow(1/3)`` stands in for ``jnp.cbrt`` on
u in [0,1); the two differ by a few ulp (tests hold them to atol 1e-6).
"""
from __future__ import annotations

import torch

TWO_PI = 6.28318530718


def disk_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform on the unit disk from two U[0,1) draws, polar method
    (common.glsl:71-76). [*shape, 2]"""
    r = torch.sqrt(u1)
    phi = u2 * TWO_PI
    return torch.stack([r * torch.sin(phi), r * torch.cos(phi)], dim=-1)


def unit_sphere_from_uniforms(u1: torch.Tensor, u2: torch.Tensor,
                              u3: torch.Tensor) -> torch.Tensor:
    """Uniform inside the unit sphere from three U[0,1) draws,
    cube-root-radius method (common.glsl:78-84). [*shape, 3]"""
    x = u1 * 2.0 - 1.0
    phi = u2 * TWO_PI
    r = u3.pow(1.0 / 3.0)
    s = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    return r[..., None] * torch.stack(
        [s * torch.sin(phi), s * torch.cos(phi), x], dim=-1)


def unit_vector_from_uniforms(u1: torch.Tensor, u2: torch.Tensor,
                              u3: torch.Tensor) -> torch.Tensor:
    """Normalized unit-sphere sample for cosine-ish diffuse scatter
    (common.glsl:86-89)."""
    v = unit_sphere_from_uniforms(u1, u2, u3)
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-12)


def uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """U[0,1) float32 draws of ``shape`` on the generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)


def sample_unit_disk(generator: torch.Generator, shape) -> torch.Tensor:
    return disk_from_uniforms(uniform(generator, shape),
                              uniform(generator, shape))


def sample_unit_sphere(generator: torch.Generator, shape) -> torch.Tensor:
    return unit_sphere_from_uniforms(uniform(generator, shape),
                                     uniform(generator, shape),
                                     uniform(generator, shape))


def sample_unit_vector(generator: torch.Generator, shape) -> torch.Tensor:
    return unit_vector_from_uniforms(uniform(generator, shape),
                                     uniform(generator, shape),
                                     uniform(generator, shape))
