"""Primary-ray generation (the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/ops/camera.py``): the pinhole
PrimaryRay overload of the reference (camera.h:91-108) and the thin-lens one
(camera.h:110-127), with depth of field and shutter-time motion blur on
values its caller drew: the Whitted renderer's sample plan
(models/samples.py) and the path tracer's uniforms; ``with_eye``, the
moved eye of inverse rendering (parallel/dist.py) and of the viewers; and
``orbit_eye``, the viewers' orbit (cli.py orbit, view, live).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import Camera, Rays, normalize
from .sampling import disk_from_uniforms


def pinhole_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor,
                 time: torch.Tensor | None = None) -> Rays:
    """px, py: [R] pixel-sample coordinates in viewport space (x+0.5 etc.).

    dir = u*w*(px/res_x - 0.5) + v*h*(py/res_y - 0.5) - n*plane_dist,
    normalized (camera.h:93-98).
    """
    sx = cam.w * (px / cam.res_x - 0.5)
    sy = cam.h * (py / cam.res_y - 0.5)
    d = (sx[:, None] * cam.u[None, :]
         + sy[:, None] * cam.v[None, :]
         - cam.plane_dist * cam.n[None, :])
    d = normalize(d)
    o = cam.eye[None, :].expand(d.shape)
    return Rays.make(o, d, time)


def thin_lens_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor,
                   lens_xy: torch.Tensor,
                   time: torch.Tensor | None = None) -> Rays:
    """Thin-lens rays from lens samples (already scaled by aperture) to the
    focal-plane point (camera.h:110-127).

    p = (w*(px/res_x-0.5)*focal, h*(py/res_y-0.5)*focal);
    dir = u*(p.x-ls.x) + v*(p.y-ls.y) + n*(-focal*plane_dist), normalized;
    origin = eye + u*ls.x + v*ls.y.
    """
    fpx = cam.w * (px / cam.res_x - 0.5) * cam.focal_ratio
    fpy = cam.h * (py / cam.res_y - 0.5) * cam.focal_ratio
    lx, ly = lens_xy[..., 0], lens_xy[..., 1]
    d = ((fpx - lx)[:, None] * cam.u[None, :]
         + (fpy - ly)[:, None] * cam.v[None, :]
         - (cam.focal_ratio * cam.plane_dist) * cam.n[None, :])
    d = normalize(d)
    o = (cam.eye[None, :]
         + lx[:, None] * cam.u[None, :]
         + ly[:, None] * cam.v[None, :])
    return Rays.make(o, d, time)


def primary_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor, *,
                 depth_of_field: bool = False, motion_blur: bool = False,
                 time_u: torch.Tensor | None = None,
                 lens_u: torch.Tensor | None = None) -> Rays:
    """Dispatch matching renderScene's ray setup (main.cpp:757-798).

    ``time_u`` [R] (motion blur) and ``lens_u`` [R, 2] (depth of field) are
    raw U[0,1) draws: the shutter time is time0 + u·(time1 - time0), the lens
    sample the unit-disk point of the two draws scaled by the aperture."""
    time = None
    if motion_blur:
        if time_u is None:
            raise ValueError("motion blur needs drawn shutter times (time_u)")
        time = cam.time0 + time_u * (cam.time1 - cam.time0)
    if depth_of_field:
        if lens_u is None:
            raise ValueError("depth of field needs drawn lens samples "
                             "(lens_u)")
        lens = disk_from_uniforms(lens_u[:, 0], lens_u[:, 1]) * cam.aperture
        return thin_lens_rays(cam, px, py, lens, time)
    return pinhole_rays(cam, px, py, time)


def with_eye(cam: Camera, eye: torch.Tensor) -> Camera:
    """The camera moved to ``eye`` [3], its uvn frame re-derived with torch
    ops so that a gradient on the eye reaches the rays: Camera::SetEye
    (camera.h:80-89), as JAX ``ops/camera.py:80-100``. ``at`` is the point
    the current frame looks at, eye_old - n·plane_dist, and the old v
    stands in for the up vector, which the camera does not keep."""
    eye = eye.to(torch.float32)
    at = cam.eye - cam.n * cam.plane_dist
    up = cam.v
    n = eye - at
    plane_dist = torch.linalg.vector_norm(n)
    n = n / plane_dist
    u = torch.linalg.cross(up, n)
    u = u / torch.linalg.vector_norm(u)
    v = torch.linalg.cross(n, u)
    return dataclasses.replace(cam, eye=eye, u=u, v=v, n=n,
                               plane_dist=plane_dist)


def orbit_eye(cam: Camera, alpha_deg, beta_deg, radius) -> torch.Tensor:
    """The eye [3] (f32, on the camera's device) on the sphere of
    ``radius`` about the origin at yaw ``alpha_deg`` and pitch
    ``beta_deg``: the reference's mouse orbit (main.cpp:419-421), as JAX
    ``ops/camera.py:102-108``."""
    dev = cam.eye.device
    a = torch.deg2rad(torch.as_tensor(alpha_deg, dtype=torch.float32,
                                      device=dev))
    b = torch.deg2rad(torch.as_tensor(beta_deg, dtype=torch.float32,
                                      device=dev))
    return torch.stack([radius * torch.sin(a) * torch.cos(b),
                        radius * torch.sin(b),
                        radius * torch.cos(a) * torch.cos(b)])
