"""Primary-ray generation (the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/ops/camera.py``): the pinhole
PrimaryRay overload of the reference (camera.h:91-108). Thin-lens depth of
field and shutter-time motion blur are not ported yet.
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


def primary_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor, *,
                 depth_of_field: bool = False,
                 motion_blur: bool = False) -> Rays:
    """Dispatch matching renderScene's ray setup (main.cpp:757-798)."""
    if depth_of_field or motion_blur:
        raise NotImplementedError(
            "depth of field and motion blur are not ported yet (ROADMAP.md, "
            "queue 1, item 7 'Distribution mode and skybox')")
    return pinhole_rays(cam, px, py)
