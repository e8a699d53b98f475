"""Sharded rendering and inverse rendering over ``torch.distributed``: the
counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/parallel/dist.py``.

Pixels are the batch axis and shard over the ranks of a process group; the
scene is replicated on every rank. The group takes the place of JAX's mesh:
every sharded function takes ``group=None``, the world group. Without an
initialised ``torch.distributed`` a call runs as world size 1 and issues no
collective; a process group named, or ``WORLD_SIZE`` above 1, without one
initialised is an error (``world``), so nothing runs alone by mistake.

  * **Ranks and cards.** On NCCL rank r runs on ``cuda:LOCAL_RANK``, one
    rank a card (``rank_device``: NCCL refuses two ranks on one device);
    gloo ranks run where their caller says, so several may share a card.
  * **Shards.** Rank r renders a contiguous slice of the flat pixel list of
    ``models/whitted.pixel_grid``, cut as ``torch.tensor_split`` cuts it
    (``shard_bounds``): the first n mod size ranks take one pixel more.
    No pixel is rendered twice. (JAX pads the list to a multiple of the
    mesh with pixel (0, 0) and, in its train steps, a zero target, so its
    loss and gradients count a phantom pixel whenever the pixel count is
    not a multiple of the device count;
    ``tests/test_torch_dist_pad_pin.py``.)
  * **The image.** ``gather_rows`` assembles the slices on every rank as
    JAX's ``out_specs=P(AXIS)`` does, with an all-gather
    (``all_gather_rows``): each rank's slice, padded with zero rows to the
    largest slice (ceil(n / size) rows), is gathered into one [size,
    ceil(n / size), C] buffer whose padding rows are dropped. gloo has no
    all-gather of CUDA tensors, so on gloo with CUDA tensors each rank
    writes its slice into a zero-filled [n, C] tensor and one
    ``all_reduce(SUM)`` assembles the whole, exactly (x + 0 = x;
    ``all_reduce_rows``). Both give the same image bit for bit.
  * **Draws.** At world size 1 the caller's generator is used as it is, so
    a call is the unsharded function's. Above it rank r draws from its own
    ``torch.Generator`` (``rank_generator``) seeded by ``rank_seed(base,
    r)``: the 8-byte BLAKE2b digest of ``"base:r"`` read little-endian
    and shifted right one bit (63 bits); ``base`` is 0 without a
    generator, else one ``randint(0, 2**62)`` drawn from the caller's
    generator (which advances it, as a frame's draws would) and read on
    the host. The ranks' draws are decorrelated, as JAX's
    ``fold_in(key, axis_index)`` decorrelates its shards'.
  * **Gradients.** Each rank's loss is sum((render - target)²) over its own
    pixels divided by the whole image's pixel count; the loss and every
    gradient leaf are summed over the group by one ``all_reduce`` of one
    flattened buffer, and every rank applies the same update and
    projections, so the replicas stay equal.
  * **Compiled programs.** JAX jits each sharded function over the mesh,
    its collective inside the program. Here, on CUDA tensors,
    ``render_image_sharded``, ``pt_frame_sharded`` and ``make_train_step``'s
    steps are CUDA graphs (``utils/graphs.py``), captured once a static
    signature (the config, the engine, (rank, size), the backend and the
    group) and replayed. The rank's seed is derived on the host before the
    replay (one draw from the caller's generator, then ``rank_seed``) and
    its generator is the one the graph draws from, so a replay draws what
    the eager call draws and leaves the caller's generator where the eager
    call leaves it. Where the collective goes depends on the backend
    (``collective_in_graph``):

      - on NCCL the rank's whole program is one graph: its pixel slice,
        the render (K1 on the megakernel engine, the walk K5 on a BVH
        scene, K3 for the path tracer), the all-gather, and in a train
        step the forward, ``torch.autograd.grad``, the gradients'
        ``all_reduce``, the update and the projections;
      - on gloo with CUDA tensors the collective cannot be captured: it
        goes through the host. The rank's local work (the render, or the
        loss and gradients) is the graph; the collective runs eagerly
        after the replay, and so does the step's update that follows it.
        The kernels still run inside the graph on the card.

    CPU tensors run the eager functions. ``render_image_sharded_eager``
    and ``pt_frame_sharded_eager`` are the functions the graphs capture,
    on any device: the reference each replay is held to.

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
import gc
import hashlib
import os
import warnings

import torch
import torch.distributed as dist

from ..core import constants as C
from ..core.types import Materials, RenderConfig, Scene
from ..utils import graphs
from ..utils.profiling import span

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
    the rank's device is ``rank_device(device, backend)``, made current on
    CUDA and, on NCCL, bound to the group (its communicator made at once);
    the group's collectives time out after TIMEOUT_S."""
    if num_processes is None or num_processes <= 1:
        return False
    if backend is None:
        backend = ("gloo" if device is not None
                   and torch.device(device).type != "cuda" else "nccl")
    dev = rank_device(device, backend)
    if coordinator_address is None:
        init = "env://"
        if process_id is None:
            process_id = int(os.environ["RANK"])
    elif process_id is None:
        raise ValueError("a coordinator address needs the process_id")
    else:
        init = f"tcp://{coordinator_address}"
    join_group(backend, init, num_processes, process_id, dev, TIMEOUT_S)
    return True


def join_group(backend: str, init_method: str, size: int, rank: int,
               device, timeout_s: float) -> None:
    """Join the process group as rank ``rank`` of ``size`` on ``device``
    (made current on CUDA; on NCCL bound to the group, so its
    communicator is made at once). From then on every capture of the
    process is thread-local (``graphs.CACHE.capture_mode``): the group's
    own threads call CUDA while a capture is open (NCCL's watchdog queries
    events), which a global capture forbids to every thread."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    bind = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **bind)
    graphs.CACHE.capture_mode = "thread_local"


def leave_group() -> None:
    """Destroy the process group, after the compiled programs of this
    process: their graphs may hold the group's NCCL collectives, which
    must not outlive its communicator (NCCL ranks across cards hung in
    teardown while they did); later captures are global again. Does
    nothing without a process group."""
    if not _initialised():
        return
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    graphs.CACHE.clear()
    gc.collect()
    dist.destroy_process_group()
    graphs.CACHE.capture_mode = "global"


def rank_device(device=None, backend: str = "nccl") -> torch.device:
    """This rank's device. A CPU ``device`` is itself. On NCCL a CUDA rank
    runs on ``cuda:LOCAL_RANK`` (torchrun's and ``launch.run``'s local
    rank, 0 when unset), one rank a card, whatever card ``device`` names;
    raises if the host has no such card. On gloo it runs on ``device``
    (None or an unindexed ``cuda``: the current card), so gloo ranks may
    share a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if backend != "nccl":
        return (dev if dev.index is not None
                else torch.device("cuda", torch.cuda.current_device()))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    cards = torch.cuda.device_count()
    if local >= cards:
        raise RuntimeError(
            f"NCCL rank with LOCAL_RANK {local} needs card {local}; this "
            f"host has {cards} (NCCL refuses two ranks on one device)")
    return torch.device("cuda", local)


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


def backend_of(group=None) -> str | None:
    """The group's backend ("nccl", "gloo"), None without a process
    group."""
    return str(dist.get_backend(group)) if _initialised() else None


def collective_in_graph(group=None) -> bool:
    """Whether a compiled sharded program captures its collective in its
    graph: on NCCL, and without a process group (no collective at all).
    gloo's collectives on CUDA tensors go through the host, so there the
    collective runs eagerly after the replay."""
    return backend_of(group) in (None, "nccl")


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
    draw of ``randint(0, 2**62)`` from it, read on the host (outside any
    graph: a compiled call derives it before its replay)."""
    if size == 1:
        return generator
    base = 0 if generator is None else int(torch.randint(
        0, 2**62, (1,), generator=generator, device=generator.device))
    return torch.Generator(device=device).manual_seed(rank_seed(base, rank))


def _rank_draws(generator, group, device, draws: bool = True):
    """The generator this rank's program draws from (``rank_generator``,
    which advances the caller's generator as the eager call does): None
    when the program draws nothing (``draws`` false), one seeded 0 when it
    draws and there is none (as ``render_tile`` seeds its own)."""
    rank, size = world(group)
    g = rank_generator(generator, rank, size, device)
    if not draws:
        return None
    return torch.Generator(device=device).manual_seed(0) if g is None else g


def all_reduce_rows(part: torch.Tensor, n: int, start: int,
                    group=None) -> torch.Tensor:
    """The [n, ...] tensor whose rows [start, start + len(part)) are this
    rank's ``part``, assembled on every rank by one ``all_reduce(SUM)``
    over a zero-filled tensor (the form gloo takes on CUDA tensors)."""
    full = part.new_zeros((n,) + tuple(part.shape[1:]))
    full[start:start + part.shape[0]] = part
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full


def _assemble(blocks: torch.Tensor, n: int) -> torch.Tensor:
    """The [n, ...] rows of an all-gather's [size, m, ...] blocks: rank r's
    first b - a rows at [a, b) (``shard_bounds``), its padding dropped."""
    size = blocks.shape[0]
    full = blocks.new_empty((n,) + tuple(blocks.shape[2:]))
    for r in range(size):
        a, b = shard_bounds(n, size, r)
        full[a:b] = blocks[r, :b - a]
    return full


def all_gather_rows(part: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """The [n, ...] tensor of every rank's ``part`` in rank order (each
    rank's slice of ``shard_bounds``), assembled on every rank by one
    all-gather: each part padded with zero rows to ceil(n / size) rows,
    the padding dropped after the gather (the form NCCL and gloo's CPU
    tensors take)."""
    _, size = world(group)
    m = -(-n // size)
    rest = tuple(part.shape[1:])
    send = part.new_zeros((m,) + rest)
    send[:part.shape[0]] = part
    recv = part.new_empty((size * m,) + rest)
    with warnings.catch_warnings():
        # torch 2.13 names it all_gather_single; 2.11 has only this name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(recv, send, group=group)
    return _assemble(recv.view((size, m) + rest), n)


def gather_rows(part: torch.Tensor, n: int, start: int,
                group=None) -> torch.Tensor:
    """The [n, ...] tensor whose rows [start, start + len(part)) are this
    rank's ``part`` and the others' the other ranks', on every rank:
    ``all_reduce_rows`` on gloo with CUDA tensors, else
    ``all_gather_rows``; ``part`` itself without a process group."""
    if not _initialised():
        return part
    if part.is_cuda and backend_of(group) == "gloo":
        return all_reduce_rows(part, n, start, group)
    return all_gather_rows(part, n, group)


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


# ---------------------------------------------------------------------------
# compiled sharded programs (JAX's jit over shard_map)


def _sharded_call(name: str, local, finish, args: tuple, g, static,
                  group, keep=frozenset()):
    """``finish(local(*args, g), *args)`` as a compiled program on the
    card: ``local`` the rank's own work, ``finish`` the collective and
    what follows it. Where ``collective_in_graph``, both are one graph;
    else ``local`` is the graph and ``finish`` runs eagerly after its
    replay (module doc). The graph is specialised on ``static`` (the
    config, the engine), (rank, size), the backend and the group."""
    static = (static, world(group), backend_of(group), group)
    if collective_in_graph(group):
        return graphs.CACHE.call(
            name, lambda *xs: finish(local(*xs), *xs[:-1]), args, g,
            static=static, keep=keep)
    part = graphs.CACHE.call(name + ".local", local, args, g, static=static,
                             keep=keep)
    return finish(part, *args)


def _pixel_shard(cam, device, group):
    """(px, py, n, start): this rank's slice of the camera's pixels, n the
    whole frame's count."""
    from ..models.whitted import pixel_grid

    rank, size = world(group)
    px, py = pixel_grid(cam.res_x, cam.res_y, device)
    n = px.shape[0]
    a, b = shard_bounds(n, size, rank)
    return px[a:b], py[a:b], n, a


def _frame_of(part, cam, group) -> torch.Tensor:
    """The whole frame [res_y, res_x, 3] on every rank from each rank's
    slice ``part``."""
    rank, size = world(group)
    n = cam.res_x * cam.res_y
    start = shard_bounds(n, size, rank)[0]
    return gather_rows(part, n, start, group).reshape(cam.res_y, cam.res_x, 3)


def _render_part(scene: Scene, cfg: RenderConfig, g, group) -> torch.Tensor:
    """This rank's slice of the frame, drawn from ``g``."""
    from ..models.whitted import render_tile

    px, py, _, _ = _pixel_shard(scene.camera, scene.device, group)
    return render_tile(scene, px, py, cfg, g)


def _whitted_draws(scene: Scene, cfg: RenderConfig, generator, group):
    """``_rank_draws`` of a Whitted frame: None when ``cfg`` draws nothing
    on ``scene``."""
    from ..models.whitted import stochastic

    return _rank_draws(generator, group, scene.device,
                       stochastic(scene, cfg))


def render_image_sharded_eager(scene: Scene, cfg: RenderConfig, group=None,
                               generator=None) -> torch.Tensor:
    """``render_image_sharded`` op by op on any device: the program its
    graph captures, and the reference a replay is held to."""
    g = _whitted_draws(scene, cfg, generator, group)
    return _frame_of(_render_part(scene, cfg, g, group), scene.camera, group)


def render_image_sharded(scene: Scene, cfg: RenderConfig, group=None,
                         generator=None) -> torch.Tensor:
    """The full frame [res_y, res_x, 3] on every rank, each rank rendering
    its slice of the pixels with ``models/whitted.render_tile`` on
    ``cfg.engine`` (on CUDA tensors the megakernel engine launches the
    Whitted kernel once a subpixel a rank) and drawing from
    ``rank_generator``; the slices gathered by ``gather_rows``. At world
    size 1 it is ``render_image(scene, cfg, generator)``. On CUDA tensors
    it is a compiled program (module doc): one graph a rank on NCCL, the
    render's graph and an eager gather on gloo; on CPU tensors
    ``render_image_sharded_eager``."""
    from ..models.whitted import SCENE_TABLES

    if not graphs.on_card(scene.device):
        return render_image_sharded_eager(scene, cfg, group, generator)
    g = _whitted_draws(scene, cfg, generator, group)
    return _sharded_call(
        "dist.render_image_sharded",
        lambda s, g: _render_part(s, cfg, g, group),
        lambda part, s: _frame_of(part, s.camera, group), (scene,), g, cfg,
        group, SCENE_TABLES)


def _pt_part(scene, tables, cam, cfg, g, engine: str, group):
    """This rank's slice of a path-traced frame: its pixels' camera
    samples, then its [B, 11, R_rank] uniforms from ``g``, traced by the
    path-tracer kernel on ``tables`` or by ``ray_color_presampled`` on
    ``scene`` (engine "plain")."""
    from ..models import pathtracer as pt
    from ..models import pt_megakernel as ptk

    px, py, _, _ = _pixel_shard(cam, cam.eye.device, group)
    rays = pt.camera_rays(cam, g, px, py)
    uni = pt.draw_uniforms(g, cfg.max_bounces, px.shape[0])
    if engine == "plain":
        return pt.ray_color_presampled(scene, cfg, rays, uni)
    return ptk.trace_rays_megakernel(tables, rays.origin, rays.direction,
                                     rays.time, uni, cfg)


def _pt_tables(scene, engine: str):
    from ..models import pt_megakernel as ptk

    if engine not in ptk.ENGINES:
        raise ValueError(f"engine {engine!r}: want one of {ptk.ENGINES}")
    return None if engine == "plain" else ptk.pt_tables(scene)


def pt_frame_sharded_eager(scene, cam, cfg, group=None, generator=None,
                           engine: str = "megakernel") -> torch.Tensor:
    """``pt_frame_sharded`` op by op on any device: the program its graph
    captures, and the reference a replay is held to."""
    tables = _pt_tables(scene, engine)
    g = _rank_draws(generator, group, scene.device)
    return _frame_of(_pt_part(scene, tables, cam, cfg, g, engine, group),
                     cam, group)


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
    ``pt_megakernel.make_render_frame(scene, cam, cfg, engine)``'s frame.
    On CUDA tensors a compiled program (module doc): the camera (and the
    plain engine's scene) the graph's inputs, the kernel's tables (packed
    once per scene) kept by identity; on CPU tensors
    ``pt_frame_sharded_eager``."""
    if not graphs.on_card(scene.device):
        return pt_frame_sharded_eager(scene, cam, cfg, group, generator,
                                      engine)
    tables = _pt_tables(scene, engine)
    g = _rank_draws(generator, group, scene.device)
    if engine == "plain":
        return _sharded_call(
            "dist.pt_frame_sharded",
            lambda s, c, g: _pt_part(s, None, c, cfg, g, engine, group),
            lambda part, s, c: _frame_of(part, c, group), (scene, cam), g,
            (cfg, engine), group)
    # the tables are the graph's by identity: the closure holds them while
    # the graph lives, so their id is not reused in a key
    return _sharded_call(
        "dist.pt_frame_sharded",
        lambda c, g: _pt_part(None, tables, c, cfg, g, engine, group),
        lambda part, c: _frame_of(part, c, group), (cam,), g,
        (cfg, engine, id(tables)), group)


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


def _image_loss(scene: Scene, target: torch.Tensor, cfg: RenderConfig, g,
                group) -> torch.Tensor:
    """This rank's share of the JAX loss: sum((render - target)²) over its
    slice of the pixels divided by the whole frame's pixel count (row 0
    the bottom scanline), drawn from the rank's generator ``g``; the shares
    sum to the loss."""
    from ..models.whitted import render_tile

    px, py, n, a = _pixel_shard(scene.camera, scene.device, group)
    img = render_tile(scene, px, py, cfg, g)
    tgt = target.reshape(-1, 3)[a:a + px.shape[0]]
    return ((img - tgt) ** 2).sum() / float(n)


def _local_grads(loss: torch.Tensor, leaves: list) -> tuple:
    """(loss, gradients) of this rank's share, not yet summed over the
    group: each gradient zeros where a leaf takes none."""
    grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
             if loss.requires_grad else [None] * len(leaves))
    return loss.detach(), tuple(torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads))


def _summed(part: tuple, group) -> tuple:
    """(loss, gradients) of ``_local_grads`` summed over the group in one
    all_reduce."""
    loss, *grads = all_reduce_sum([part[0], *part[1]], group)
    return loss, grads


def _material_grads(scene: Scene, target, cfg: RenderConfig, g, group):
    """This rank's (loss, gradients of the seven material fields)."""
    mats = _leaf_params(params_of(scene)).materials
    leaves = [getattr(mats, f) for f in _MAT_FIELDS]
    loss = _image_loss(dataclasses.replace(scene, materials=mats), target,
                       cfg, g, group)
    return _local_grads(loss, leaves)


def _material_update(part: tuple, scene: Scene, lr: float, group):
    """(scene', loss): the materials stepped by the group's gradient."""
    loss, grads = _summed(part, group)
    with torch.no_grad():
        new = Materials(**{f: getattr(scene.materials, f) - lr * g
                           for f, g in zip(_MAT_FIELDS, grads)})
        new = _project_materials(new)
    return dataclasses.replace(scene, materials=new), loss


def _full_grads(scene: Scene, target, cfg: RenderConfig, g, freeze, group):
    """This rank's (loss, gradients of every FitParams leaf)."""
    p0 = _leaf_params(params_of(scene))
    loss = _image_loss(_apply_params(scene, _freeze_params(p0, freeze)),
                       target, cfg, g, group)
    return _local_grads(loss, tree_leaves(p0))


def _full_update(part: tuple, scene: Scene, lr: float, scales: FitParams,
                 group):
    """(scene', loss): every group stepped by the group's gradient times
    its scale, then projected back to the valid domain."""
    loss, grads = _summed(part, group)
    with torch.no_grad():
        new = tree_map(lambda p, g, s: p - lr * s * g, params_of(scene),
                       tree_unflatten(grads), scales)
        pp = new.prim_params
        is_sph = scene.prims.ptype == C.SPHERE
        pp[:, 3] = torch.where(is_sph, pp[:, 3].clamp(min=1e-3), pp[:, 3])
        new = dataclasses.replace(
            new, materials=_project_materials(new.materials),
            cam_focal=new.cam_focal.clamp(min=0.05), prim_params=pp)
        return _apply_params(scene, new), loss


def train_step(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
               lr: float = 0.05, generator=None, group=None):
    """One step of inverse rendering on the materials alone: the render
    is fitted to ``target`` [H, W, 3] (row 0 the bottom), the pixels
    sharded over ``group``. Returns (scene', loss), loss a 0-d tensor."""
    g = _whitted_draws(scene, cfg, generator, group)
    return _material_update(_material_grads(scene, target, cfg, g, group),
                            scene, lr, group)


def value_and_grad(scene: Scene, target: torch.Tensor, cfg: RenderConfig,
                   generator=None, freeze: tuple = (), group=None):
    """(loss, gradient) of the JAX loss at the scene's parameters, the
    pixels sharded over ``group``: the loss a 0-d tensor, the gradient a
    ``FitParams`` (zeros where a leaf takes none: a group in ``freeze``, or
    a parameter the render only compares, such as ``transmit``), both
    summed over the group."""
    g = _whitted_draws(scene, cfg, generator, group)
    loss, grads = _summed(_full_grads(scene, target, cfg, g, freeze, group),
                          group)
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
    g = _whitted_draws(scene, cfg, generator, group)
    return _full_update(_full_grads(scene, target, cfg, g, freeze, group),
                        scene, lr, scales, group)


# ---------------------------------------------------------------------------
# compiled train steps (JAX's jitted train_step and train_step_full,
# parallel/dist.py:101, :273)

# the Scene fields a compiled step keeps whole: the tables a step does not
# change (Scene.brute is rebuilt by the step from the primitive table, so it
# is an input like the rest)
STEP_TABLES = frozenset({"skybox", "packets", "bvh", "grid"})


def make_train_step(step, cfg: RenderConfig, lr: float = 0.05, *,
                    scales: FitParams | None = None, freeze: tuple = (),
                    group=None):
    """``run(scene, target, generator=None) -> (scene', loss)``: ``step``
    (``train_step`` or ``train_step_full``, the latter with ``scales`` and
    ``freeze``) over ``group`` as a compiled program on CUDA tensors
    (module doc). The scene's parameter groups and the target are the CUDA
    graph's inputs; the rank's forward (``WhittedTrace`` on the megakernel
    engine: one K1 launch a subpixel; or the sweep or the wavefront) and
    ``torch.autograd.grad`` are captured, and on NCCL or without a process
    group also the gradients' all_reduce, the update and the projections;
    on gloo those run eagerly after the replay. The returned scene is
    cloned from the graph's outputs (the tables it does not change,
    ``STEP_TABLES``, are the caller's). On CPU tensors ``run`` is the
    eager ``step``. A call of ``run`` is the entry span ``rt.train_step``
    (``utils/profiling``). The backward adds with atomics, so a replay equals the
    eager step within the gradient's rounding, not bit for bit."""
    if step is train_step:
        if scales is not None or freeze:
            raise ValueError("train_step takes no scales or freeze")
        kw = {}
        static = ("train_step", cfg, lr)

        def local(s, t, g):
            return _material_grads(s, t, cfg, g, group)

        def finish(part, s, t):
            return _material_update(part, s, lr, group)
    elif step is train_step_full:
        scales = lr_scales() if scales is None else scales
        freeze = tuple(freeze)
        kw = {"scales": scales, "freeze": freeze}
        # a tensor scale is the graph's by identity (the program holds it)
        static = ("train_step_full", cfg, lr, freeze, tuple(
            ("tensor", id(s)) if torch.is_tensor(s) else s
            for s in tree_leaves(scales)))

        def local(s, t, g):
            return _full_grads(s, t, cfg, g, freeze, group)

        def finish(part, s, t):
            return _full_update(part, s, lr, scales, group)
    else:
        raise ValueError(f"make_train_step compiles train_step or "
                         f"train_step_full, not {step!r}")

    def run(scene: Scene, target: torch.Tensor, generator=None):
        with span("rt.train_step", entry=True):
            if not graphs.on_card(scene.device):
                return step(scene, target, cfg, lr, generator, group=group,
                            **kw)
            g = _whitted_draws(scene, cfg, generator, group)
            return _sharded_call("dist." + step.__name__, local, finish,
                                 (scene, target), g, static, group,
                                 STEP_TABLES)

    return run
