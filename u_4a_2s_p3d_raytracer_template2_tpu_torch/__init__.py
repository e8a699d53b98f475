"""PyTorch and CUDA port of the ray tracer in
``u_4a_2s_p3d_raytracer_template2_tpu`` (JAX, TPU), which stays the
reference it is tested against.

This package imports torch and numpy, never jax or the JAX package. Its main
path is the Whitted render of the built-in mount_low scene: the sweep engine
in PyTorch, and the whole recursion tree in one hand-written CUDA kernel
(``csrc/whitted_megakernel.cu``) for ``engine="megakernel"`` on CUDA tensors.

Quick start::

    import torch
    import u_4a_2s_p3d_raytracer_template2_tpu_torch as rt
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import mount_scene
    scene = rt.build_scene(mount_scene(res=512), device=torch.device("cuda"))
    img = rt.render_image(scene, rt.RenderConfig(engine="megakernel"))
    rt.save_png("out.png", img)   # [H, W, 3] float, row 0 = bottom
"""

from .core import constants
from .core.build import build_camera, build_scene
from .core.types import (
    Camera,
    Lights,
    Materials,
    Primitives,
    Rays,
    RenderConfig,
    Scene,
)
from .io.image import save_png
from .io.p3f import SceneDef, parse_p3f, parse_p3f_text
from .models.whitted import render_image, render_tile, trace_rays

__version__ = "0.1.0"
