"""Primary-ray generation (the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/ops/camera.py``): the pinhole
PrimaryRay overload of the reference (camera.h:91-108) and the thin-lens one
(camera.h:110-127), which the path tracer uses with lens samples and shutter
times drawn by its caller. The Whitted renderer's depth of field and motion
blur are not ported yet.
"""
from __future__ import annotations

import torch

from ..core.types import Camera, Rays, normalize


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
                 depth_of_field: bool = False,
                 motion_blur: bool = False) -> Rays:
    """Dispatch matching renderScene's ray setup (main.cpp:757-798)."""
    if depth_of_field or motion_blur:
        raise NotImplementedError(
            "depth of field and motion blur are not ported yet (ROADMAP.md, "
            "queue 1, item 7 'Distribution mode and skybox')")
    return pinhole_rays(cam, px, py)
