"""Sharded rendering and inverse rendering over ``torch.distributed``: the
counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/parallel/dist.py``.

Pixels are the batch axis and shard over the ranks of a process group; the
scene is replicated on every rank. The group takes the place of JAX's mesh:
every sharded function takes ``group=None``, the world group. Without an
initialised ``torch.distributed`` a call runs as world size 1 and issues no
collective; a process group named, or ``WORLD_SIZE`` above 1, without one
initialised is an error (``world``), so nothing runs alone by mistake.

  * **Shards.** Rank r renders a contiguous slice of the flat pixel list of
    ``models/whitted.pixel_grid``, cut as ``torch.tensor_split`` cuts it
    (``shard_bounds``): the first n mod size ranks take one pixel more.
    There is no padding. (JAX pads the list to a multiple of the mesh with
    pixel (0, 0) and, in its train steps, a zero target, so its loss and
    gradients count a phantom pixel whenever the pixel count is not a
    multiple of the device count; ``tests/test_torch_dist_pad_pin.py``.)
  * **The image.** ``gather_rows``: each rank writes its slice into a
    zero-filled [n, C] tensor and one ``all_reduce(SUM)`` assembles the
    whole on every rank, exactly (x + 0 = x). It is the one collective that
    NCCL and gloo both take on CUDA tensors (gloo has no CUDA all_gather);
    it moves n·C·4 bytes a rank, 3 MiB for a 512x512 RGB frame.
  * **Draws.** At world size 1 the caller's generator is used as it is, so
    a call is the unsharded function's. Above it rank r draws from its own
    ``torch.Generator`` (``rank_generator``) seeded by ``rank_seed(base,
    r)``: the 8-byte BLAKE2b digest of ``"base:r"`` read little-endian
    and shifted right one bit (63 bits); ``base`` is 0 without a
    generator, else one ``randint(0, 2**62)`` drawn from the caller's
    generator (which advances it, as a frame's draws would). The ranks'
    draws are decorrelated, as JAX's ``fold_in(key, axis_index)``
    decorrelates its shards'.
  * **Gradients.** Each rank's loss is sum((render - target)²) over its own
    pixels divided by the whole image's pixel count; the loss and every
    gradient leaf are summed over the group by one ``all_reduce`` of one
    flattened buffer, and every rank applies the same update and
    projections, so the replicas stay equal.

``FitParams`` holds every differentiable parameter group of a scene
(materials, light positions and colours, the camera's eye and focal ratio,
the unified primitive table); ``train_step`` fits the materials and
``train_step_full`` every group, each one step of gradient descent on the
JAX package's loss with its projections back to the valid domain. The
render is ``models/whitted.render_tile`` on ``cfg.engine``: on the
megakernel engine a CUDA step launches the Whitted kernel forward (once a
subpixel, on each rank) and differentiates its plain version
(``whitted_megakernel.WhittedTrace``); the sweep and the wavefront take
autograd through their PyTorch ops, their traversals detached.
``pt_frame_sharded`` shards one path-traced frame the same way.
``initialize_multihost`` joins a group of processes (torchrun's, or an
address); ``parallel/launch.py`` starts ranks on one host.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os

import torch
import torch.distributed as dist

from ..core import constants as C
from ..core.types import Materials, RenderConfig, Scene

# the process group's timeout: a rank that waits longer on a collective or
# the rendezvous raises instead of hanging
TIMEOUT_S = 300.0


# ---------------------------------------------------------------------------
# process groups, shards, draws and the gather


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None, *,
                         device=None) -> bool:
    """Join a process group of ``num_processes`` ranks as rank
    ``process_id``; returns False and does nothing when ``num_processes``
    is None or at most 1 (JAX ``parallel/dist.py:389-404``).

    The rendezvous is ``tcp://coordinator_address`` (host:port), or
    torchrun's environment (``env://``: MASTER_ADDR, MASTER_PORT, and RANK
    when ``process_id`` is None) without an address. The backend is NCCL
    for a CUDA rank and gloo for a CPU rank unless ``backend`` names one;
    the rank's device is ``rank_device(device)``, made current on CUDA; the
    group's collectives time out after TIMEOUT_S."""
    if num_processes is None or num_processes <= 1:
        return False
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init = "env://"
        if process_id is None:
            process_id = int(os.environ["RANK"])
    elif process_id is None:
        raise ValueError("a coordinator address needs the process_id")
    else:
        init = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def rank_device(device=None) -> torch.device:
    """``device``, or ``cuda:LOCAL_RANK`` (torchrun's local rank, 0 when
    unset) when it is None or an unindexed ``cuda``."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def world(group=None) -> tuple[int, int]:
    """(rank, size) of this process in ``group`` (None: the world group);
    (0, 1) when torch.distributed is not initialised. Raises if a group is
    named, or ``WORLD_SIZE`` says more than one rank, without one."""
    if _initialised():
        return dist.get_rank(group), dist.get_world_size(group)
    if group is not None:
        raise RuntimeError("a process group was given, but torch.distributed "
                           "is not initialised")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            f"WORLD_SIZE is {os.environ['WORLD_SIZE']} but torch.distributed "
            "is not initialised: call initialize_multihost first")
    return 0, 1


def shard_bounds(n: int, size: int, rank: int) -> tuple[int, int]:
    """[start, stop) of rank ``rank``'s slice of n items over ``size`` ranks,
    as ``torch.tensor_split`` cuts them: the first n mod size ranks take
    one item more."""
    q, r = divmod(n, size)
    start = rank * q + min(rank, r)
    return start, start + q + (rank < r)


def rank_seed(base: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: the 8-byte BLAKE2b digest of
    ``f"{base}:{rank}"`` read little-endian and shifted right one bit."""
    digest = hashlib.blake2b(f"{base}:{rank}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def rank_generator(generator, rank: int, size: int, device):
    """The generator rank ``rank`` of ``size`` draws from: ``generator``
    itself at size 1; above it a new generator on ``device`` seeded
    ``rank_seed(base, rank)``, ``base`` 0 without a generator, else one
    draw of ``randint(0, 2**62)`` from it."""
    if size == 1:
        return generator
    base = 0 if generator is None else int(torch.randint(
        0, 2**62, (1,), generator=generator, device=generator.device))
    return torch.Generator(device=device).manual_seed(rank_seed(base, rank))


def gather_rows(part: torch.Tensor, n: int, start: int,
                group=None) -> torch.Tensor:
    """The [n, ...] tensor whose rows [start, start + len(part)) are this
    rank's ``part``, assembled on every rank by one ``all_reduce(SUM)``
    over a zero-filled tensor; ``part`` itself without a process group."""
    if not _initialised():
        return part
    full = part.new_zeros((n,) + tuple(part.shape[1:]))
    full[start:start + part.shape[0]] = part
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full


def all_reduce_sum(tensors, group=None) -> list:
    """``tensors`` (one dtype and device) summed over the group by one
    ``all_reduce`` of their flattened concatenation; the tensors themselves
    without a process group."""
    tensors = list(tensors)
    if not _initialised():
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [x.view_as(t) for x, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _pixel_shard(cam, device, group):
    """(px, py, n, start, rank, size): this rank's slice of the camera's
    pixels, n the whole frame's count."""
    from ..models.whitted import pixel_grid

    rank, size = world(group)
    px, py = pixel_grid(cam.res_x, cam.res_y, device)
    n = px.shape[0]
    a, b = shard_bounds(n, size, rank)
    return px[a:b], py[a:b], n, a, rank, size


def render_image_sharded(scene: Scene, cfg: RenderConfig, group=None,
                         generator=None) -> torch.Tensor:
    """The full frame [res_y, res_x, 3] on every rank, each rank rendering
    its slice of the pixels with ``models/whitted.render_tile`` on
    ``cfg.engine`` (on CUDA tensors the megakernel engine launches the
    Whitted kernel once a subpixel a rank) and drawing from
    ``rank_generator``; the slices gathered by ``gather_rows``. At world
    size 1 it is ``render_image(scene, cfg, generator)``."""
    from ..models.whitted import render_tile

    px, py, n, a, rank, size = _pixel_shard(scene.camera, scene.device,
                                            group)
    part = render_tile(scene, px, py, cfg,
                       rank_generator(generator, rank, size, scene.device))
    cam = scene.camera
    return gather_rows(part, n, a, group).reshape(cam.res_y, cam.res_x, 3)


def pt_frame_sharded(scene, cam, cfg, group=None, generator=None,
                     engine: str = "megakernel") -> torch.Tensor:
    """One 1-spp path-traced frame [res_y, res_x, 3] (linear) on every
    rank (JAX ``parallel/dist.py:344-382``): each rank draws its pixels'
    jitter, lens and time (``pathtracer.camera_rays``) and then its ``[B,
    11, R_rank]`` uniforms from ``rank_generator`` (seed 0 at world size 1
    without a generator), and traces them with the path-tracer kernel
    (``pt_megakernel.trace_rays_megakernel``: one launch a rank on CUDA
    tensors, its plain version on CPU tensors), or with
    ``ray_color_presampled`` for ``engine="plain"``; the slices gathered by
    ``gather_rows``. At world size 1 with one generator it is
    ``pt_megakernel.make_render_frame(scene, cam, cfg, engine)``'s frame."""
    from ..models import pathtracer as pt
    from ..models import pt_megakernel as ptk

    if engine not in ptk.ENGINES:
        raise ValueError(f"engine {engine!r}: want one of {ptk.ENGINES}")
    px, py, n, a, rank, size = _pixel_shard(cam, scene.device, group)
    g = rank_generator(generator, rank, size, scene.device)
    if g is None:
        g = torch.Generator(device=scene.device).manual_seed(0)
    rays = pt.camera_rays(cam, g, px, py)
    uni = pt.draw_uniforms(g, cfg.max_bounces, px.shape[0])
    if engine == "plain":
        col = pt.ray_color_presampled(scene, cfg, rays, uni)
    else:
        col = ptk.trace_rays_megakernel(ptk.pt_tables(scene), rays.origin,
                                        rays.direction, rays.time, uni, cfg)
    return gather_rows(col, n, a, group).reshape(cam.res_y, cam.res_x, 3)

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
                generator, group) -> torch.Tensor:
    """This rank's share of the JAX loss: sum((render - target)²) over its
    slice of the pixels divided by the whole frame's pixel count (row 0
    the bottom scanline); the shares sum to the loss."""
    from ..models.whitted import render_tile

    px, py, n, a, rank, size = _pixel_shard(scene.camera, scene.device,
                                            group)
    img = render_tile(scene, px, py, cfg,
                      rank_generator(generator, rank, size, scene.device))
    tgt = target.reshape(-1, 3)[a:a + px.shape[0]]
    return ((img - tgt) ** 2).sum() / float(n)


def _loss_and_grads(loss: torch.Tensor, leaves: list, group):
    """(loss, gradients) of this rank's share, each gradient zeros where a
    leaf takes none, summed over the group in one all_reduce."""
    grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
             if loss.requires_grad else [None] * len(leaves))
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    loss, *grads = all_reduce_sum([loss.detach(), *grads], group)
    return loss, grads


def train_step(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
               lr: float = 0.05, generator=None, group=None):
    """One step of inverse rendering on the materials alone: the render
    is fitted to ``target`` [H, W, 3] (row 0 the bottom), the pixels
    sharded over ``group``. Returns (scene', loss), loss a 0-d tensor."""
    mats = _leaf_params(params_of(scene)).materials
    leaves = [getattr(mats, f) for f in _MAT_FIELDS]
    loss = _image_loss(dataclasses.replace(scene, materials=mats), target,
                       cfg, generator, group)
    loss, grads = _loss_and_grads(loss, leaves, group)
    with torch.no_grad():
        new = Materials(**{f: p - lr * g
                           for f, p, g in zip(_MAT_FIELDS, leaves, grads)})
        new = _project_materials(new)
    return dataclasses.replace(scene, materials=new), loss


def value_and_grad(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
                   generator=None, freeze: tuple = (), group=None):
    """(loss, gradient) of the JAX loss at the scene's parameters, the
    pixels sharded over ``group``: the loss a 0-d tensor, the gradient a
    ``FitParams`` (zeros where a leaf takes none: a group in ``freeze``, or
    a parameter the render only compares, such as ``transmit``), both
    summed over the group."""
    p0 = _leaf_params(params_of(scene))
    loss = _image_loss(_apply_params(scene, _freeze_params(p0, freeze)),
                       target, cfg, generator, group)
    loss, grads = _loss_and_grads(loss, tree_leaves(p0), group)
    return loss, tree_unflatten(grads)


def train_step_full(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
                    lr: float = 0.05, generator=None,
                    scales: FitParams | None = None, freeze: tuple = (),
                    group=None):
    """One inverse-rendering step over every parameter group: materials,
    light positions and colours, the camera's eye and focal ratio, and the
    primitive table. ``scales`` (``lr_scales``) multiplies lr a group; 0
    freezes a group's update. ``freeze`` (names among "materials",
    "lights", "camera", "geometry") also detaches those groups, so the
    backward does none of their work; a zero scale alone still pays for
    their gradient. Projections after the update: materials as
    ``train_step``, focal ratio >= 0.05, sphere radii >= 1e-3. The pixels
    shard over ``group``; every rank applies the same update. Returns
    (scene', loss), loss a 0-d tensor."""
    if scales is None:
        scales = lr_scales()
    loss, grads = value_and_grad(scene, target, cfg, generator, freeze,
                                 group)
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


# ---------------------------------------------------------------------------
# compiled train steps (JAX's jitted train_step and train_step_full,
# parallel/dist.py:101, :273)

# the Scene fields a compiled step keeps whole: the tables a step does not
# change (Scene.brute is rebuilt by the step from the primitive table, so it
# is an input like the rest)
STEP_TABLES = frozenset({"skybox", "packets", "bvh", "grid"})


def make_train_step(step, cfg: RenderConfig, lr: float = 0.05, *,
                    scales: FitParams | None = None, freeze: tuple = ()):
    """``run(scene, target, generator=None) -> (scene', loss)``: ``step``
    (``train_step`` or ``train_step_full``, the latter with ``scales`` and
    ``freeze``) as one compiled program on one CUDA device. The scene's
    parameter groups and the target are the CUDA graph's inputs; the eager
    step, its forward (``WhittedTrace`` on the megakernel engine: one K1
    launch a subpixel; or the sweep or the wavefront),
    ``torch.autograd.grad``, the update and the projections, is captured
    whole, and the returned scene is cloned from the graph's outputs (the
    tables it does not change, ``STEP_TABLES``, are the caller's). On CPU
    tensors, and under an initialised process group (gloo's CUDA
    all_reduce goes through the host and cannot be captured), ``run`` is
    the eager ``step``. The backward adds with
    atomics, so a replay equals the eager step within the gradient's
    rounding, not bit for bit."""
    from ..models.whitted import stochastic
    from ..utils import graphs

    if step is train_step:
        if scales is not None or freeze:
            raise ValueError("train_step takes no scales or freeze")
        kw = {}
        static = ("train_step", cfg, lr)
    elif step is train_step_full:
        scales = lr_scales() if scales is None else scales
        kw = {"scales": scales, "freeze": tuple(freeze)}
        # a tensor scale is the graph's by identity (the program holds it)
        static = ("train_step_full", cfg, lr, tuple(freeze), tuple(
            ("tensor", id(s)) if torch.is_tensor(s) else s
            for s in tree_leaves(scales)))
    else:
        raise ValueError(f"make_train_step compiles train_step or "
                         f"train_step_full, not {step!r}")

    def program(scene, target, generator):
        return step(scene, target, cfg, lr, generator, **kw)

    def run(scene: Scene, target: torch.Tensor, generator=None):
        if not graphs.on_card(scene.device) or _initialised():
            return step(scene, target, cfg, lr, generator, **kw)
        if not stochastic(scene, cfg):
            generator = None  # one graph with or without an unused one
        return graphs.CACHE.call("dist." + step.__name__, program,
                                 (scene, target), generator, static=static,
                                 keep=STEP_TABLES)

    return run
