"""Inverse rendering on one device: the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/parallel/dist.py:102-345`` without
its mesh.

``FitParams`` holds every differentiable parameter group of a scene
(materials, light positions and colours, the camera's eye and focal ratio,
the unified primitive table); ``train_step`` fits the materials and
``train_step_full`` every group, each one step of gradient descent on the
JAX package's loss, ``sum((image - target)²) / n_pixels``, with its
projections back to the valid domain. The render is ``models/whitted
.render_tile`` on ``cfg.engine``: on the megakernel engine a CUDA step
launches the Whitted kernel forward and differentiates its plain version
(``whitted_megakernel.WhittedTrace``); the sweep and the wavefront take
autograd through their PyTorch ops, their traversals detached
(accel/packets.py, ops/intersect.py, accel/traverse.py). The draws of a
stochastic config come from an explicit ``torch.Generator``.

The JAX module shards pixels over a mesh and all-reduces the gradients
(``render_image_sharded``, ``pt_frame_sharded``); the port's sharding is
ROADMAP.md queue 1, entry 5, and nothing here shards.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import constants as C
from ..core.types import Materials, RenderConfig, Scene

_MAT_FIELDS = tuple(f.name for f in dataclasses.fields(Materials))
_GROUP_FIELDS = ("light_pos", "light_color", "cam_eye", "cam_focal",
                 "prim_params")


@dataclasses.dataclass(frozen=True)
class FitParams:
    """Every differentiable scene parameter group. The camera is its eye
    and focal ratio, its uvn frame re-derived from the eye
    (``ops/camera.with_eye``); ``prim_params`` is the unified [N, 12]
    primitive table (a triangle's normal re-derived from its edges,
    ``core/build.with_prim_params``). A learning-rate scale
    (``lr_scales``) has the same structure, each leaf a float or a tensor
    that broadcasts against its group."""

    materials: Materials
    light_pos: torch.Tensor    # [L, 3]
    light_color: torch.Tensor  # [L, 3]
    cam_eye: torch.Tensor      # [3]
    cam_focal: torch.Tensor    # []
    prim_params: torch.Tensor  # [N, 12]


def tree_leaves(p: FitParams) -> list:
    """The leaves in the JAX pytree's flatten order: the seven material
    fields, then the five groups (the order of a checkpoint's arrays)."""
    return ([getattr(p.materials, f) for f in _MAT_FIELDS]
            + [getattr(p, f) for f in _GROUP_FIELDS])


def tree_unflatten(leaves) -> FitParams:
    """The ``FitParams`` of ``tree_leaves``' list."""
    leaves = list(leaves)
    n = len(_MAT_FIELDS)
    return FitParams(Materials(**dict(zip(_MAT_FIELDS, leaves[:n]))),
                     **dict(zip(_GROUP_FIELDS, leaves[n:])))


def tree_map(fn, *trees: FitParams) -> FitParams:
    """``fn`` leaf by leaf over ``FitParams`` of one structure."""
    return tree_unflatten(fn(*xs) for xs in zip(*map(tree_leaves, trees)))


def params_of(scene: Scene) -> FitParams:
    return FitParams(materials=scene.materials,
                     light_pos=scene.lights.position,
                     light_color=scene.lights.color,
                     cam_eye=scene.camera.eye,
                     cam_focal=scene.camera.focal_ratio,
                     prim_params=scene.prims.params)


def _apply_params(scene: Scene, p: FitParams) -> Scene:
    """``scene`` with the parameters ``p``: the camera's frame re-derived
    from the eye, the primitive views and brute-force tables from the
    table."""
    from ..core.build import with_prim_params
    from ..ops.camera import with_eye

    lights = dataclasses.replace(scene.lights, position=p.light_pos,
                                 color=p.light_color)
    cam = dataclasses.replace(with_eye(scene.camera, p.cam_eye),
                              focal_ratio=p.cam_focal)
    scene = dataclasses.replace(scene, materials=p.materials, lights=lights,
                                camera=cam)
    return with_prim_params(scene, p.prim_params)


def _project_materials(m: Materials) -> Materials:
    """Back to the domain where the forward pass is defined: colours and
    coefficients in [0, 1], shine >= 1 (pow), ior >= 1 (eta)."""
    return dataclasses.replace(
        m,
        diff_color=m.diff_color.clamp(0.0, 1.0),
        spec_color=m.spec_color.clamp(0.0, 1.0),
        kd=m.kd.clamp(0.0, 1.0),
        ks=m.ks.clamp(0.0, 1.0),
        transmit=m.transmit.clamp(0.0, 1.0),
        shine=m.shine.clamp(min=1.0),
        ior=m.ior.clamp(min=1.0))


def lr_scales(materials: float = 1.0, light_pos: float = 1.0,
              light_color: float = 1.0, camera: float = 1.0,
              geometry: float = 0.0) -> FitParams:
    """Per-group learning-rate multipliers for ``train_step_full``: the
    groups live on different scales (colours in [0, 1], positions in world
    units), so one lr cannot fit them together. 0 freezes a group's update.
    ``geometry`` defaults to 0: its useful lr is far below the others'. A
    leaf may be replaced by a tensor that broadcasts against its group (a
    per-row mask of ``prim_params``)."""
    return FitParams(
        materials=Materials(**{f: float(materials) for f in _MAT_FIELDS}),
        light_pos=float(light_pos), light_color=float(light_color),
        cam_eye=float(camera), cam_focal=float(camera),
        prim_params=float(geometry))


# the freeze groups' names -> FitParams fields
_FREEZE_GROUPS = {
    "materials": ("materials",),
    "lights": ("light_pos", "light_color"),
    "camera": ("cam_eye", "cam_focal"),
    "geometry": ("prim_params",),
}


def _freeze_params(params: FitParams, freeze) -> FitParams:
    """``params`` with the groups named in ``freeze`` detached: they take
    no gradient, and the backward does none of their work (JAX
    stop_gradients them)."""
    reps = {}
    for name in freeze:
        for field in _FREEZE_GROUPS[name]:
            v = getattr(params, field)
            reps[field] = (dataclasses.replace(v, **{
                f: getattr(v, f).detach() for f in _MAT_FIELDS})
                if field == "materials" else v.detach())
    return dataclasses.replace(params, **reps)


def _leaf_params(p: FitParams) -> FitParams:
    """Detached copies of ``p``'s leaves that require grad."""
    return tree_map(lambda x: x.detach().clone().requires_grad_(), p)


def _image_loss(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
                generator) -> torch.Tensor:
    """The JAX loss: sum((render - target)²) / n_pixels, the render over
    the whole frame (row 0 the bottom scanline)."""
    from ..models.whitted import pixel_grid, render_tile

    cam = scene.camera
    px, py = pixel_grid(cam.res_x, cam.res_y, scene.device)
    img = render_tile(scene, px, py, cfg, generator)
    return ((img - target.reshape(-1, 3)) ** 2).sum() / float(px.shape[0])


def train_step(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
               lr: float = 0.05, generator=None):
    """One step of inverse rendering on the materials alone: the render
    is fitted to ``target`` [H, W, 3] (row 0 the bottom). Returns
    (scene', loss), loss a 0-d tensor."""
    mats = _leaf_params(params_of(scene)).materials
    leaves = [getattr(mats, f) for f in _MAT_FIELDS]
    loss = _image_loss(dataclasses.replace(scene, materials=mats), target,
                       cfg, generator)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        new = Materials(**{
            f: p - lr * (torch.zeros_like(p) if g is None else g)
            for f, p, g in zip(_MAT_FIELDS, leaves, grads)})
        new = _project_materials(new)
    return dataclasses.replace(scene, materials=new), loss.detach()


def value_and_grad(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
                   generator=None, freeze: tuple = ()):
    """(loss, gradient) of the JAX loss at the scene's parameters: the
    loss a 0-d tensor, the gradient a ``FitParams`` (zeros where a leaf
    takes none: a group in ``freeze``, or a parameter the render only
    compares, such as ``transmit``)."""
    p0 = _leaf_params(params_of(scene))
    loss = _image_loss(_apply_params(scene, _freeze_params(p0, freeze)),
                       target, cfg, generator)
    leaves = tree_leaves(p0)
    grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
             if loss.requires_grad else [None] * len(leaves))
    return loss.detach(), tree_unflatten(
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads))


def train_step_full(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
                    lr: float = 0.05, generator=None,
                    scales: FitParams | None = None, freeze: tuple = ()):
    """One inverse-rendering step over every parameter group: materials,
    light positions and colours, the camera's eye and focal ratio, and the
    primitive table. ``scales`` (``lr_scales``) multiplies lr a group; 0
    freezes a group's update. ``freeze`` (names among "materials",
    "lights", "camera", "geometry") also detaches those groups, so the
    backward does none of their work; a zero scale alone still pays for
    their gradient. Projections after the update: materials as
    ``train_step``, focal ratio >= 0.05, sphere radii >= 1e-3. Returns
    (scene', loss), loss a 0-d tensor."""
    if scales is None:
        scales = lr_scales()
    loss, grads = value_and_grad(scene, target, cfg, generator, freeze)
    with torch.no_grad():
        new = tree_map(lambda p, g, s: p - lr * s * g, params_of(scene),
                       grads, scales)
        pp = new.prim_params
        is_sph = scene.prims.ptype == C.SPHERE
        pp[:, 3] = torch.where(is_sph, pp[:, 3].clamp(min=1e-3), pp[:, 3])
        new = dataclasses.replace(
            new, materials=_project_materials(new.materials),
            cam_focal=new.cam_focal.clamp(min=0.05), prim_params=pp)
        return _apply_params(scene, new), loss
