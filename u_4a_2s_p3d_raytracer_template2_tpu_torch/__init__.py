"""PyTorch and CUDA port of the ray tracer in
``u_4a_2s_p3d_raytracer_template2_tpu`` (JAX, TPU), which stays the
reference it is tested against.

This package imports torch and numpy, never jax or the JAX package. It has
two paths:

  * the Whitted render of the built-in mount_low scene: the sweep engine in
    PyTorch, and the whole recursion tree in one hand-written CUDA kernel
    (``csrc/whitted_megakernel.cu``) for ``engine="megakernel"`` on CUDA
    tensors;
  * the GLSL Monte Carlo path tracer on ``glsl_world``, progressive 1-spp
    frames whose bounce loop runs in one hand-written CUDA kernel
    (``csrc/pt_megakernel.cu``) on CUDA tensors.

Quick start::

    import torch
    import u_4a_2s_p3d_raytracer_template2_tpu_torch as rt
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import mount_scene
    dev = torch.device("cuda")
    scene = rt.build_scene(mount_scene(res=512), device=dev)
    img = rt.render_image(scene, rt.RenderConfig(engine="megakernel"))
    rt.save_png("out.png", img)   # [H, W, 3] float, row 0 = bottom
    scene = rt.load_scene("scene.p3f", device=dev)   # a .p3f file

    world, cam = rt.glsl_world(device=dev), rt.glsl_camera(512, 512, device=dev)
    cfg = rt.PTConfig()
    acc = rt.render_progressive(world, cam, cfg,
                                torch.Generator(device=dev).manual_seed(0),
                                16, frame_fn=rt.make_render_frame(world, cam, cfg))
    rt.save_png("pt.png", rt.to_image(acc))
"""

from .core import constants
from .core.build import build_camera, build_scene, load_scene
from .core.types import (
    Camera,
    Lights,
    Materials,
    Primitives,
    Rays,
    RenderConfig,
    Scene,
)
from .io.image import load_png, save_png
from .io.p3f import SceneDef, parse_p3f, parse_p3f_text
from .models.glsl_scene import glsl_camera, glsl_world
from .models.pathtracer import (
    Accumulator,
    PTConfig,
    PTScene,
    render_progressive,
    to_image,
)
from .models.pt_megakernel import make_render_frame
from .models.whitted import render_image, render_tile, trace_rays

__version__ = "0.1.0"
