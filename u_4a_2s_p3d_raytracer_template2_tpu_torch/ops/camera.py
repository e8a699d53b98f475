"""Primary-ray generation (the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/ops/camera.py``): the pinhole
PrimaryRay overload of the reference (camera.h:91-108) and the thin-lens one
(camera.h:110-127), with depth of field and shutter-time motion blur on
values its caller drew: the Whitted renderer's sample plan
(models/samples.py) and the path tracer's uniforms.
"""
from __future__ import annotations

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
