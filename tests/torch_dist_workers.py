"""Rank functions of the port's sharding tests (tests/test_torch_dist_*.py),
which ``parallel/launch.run`` starts in spawned processes. This module
imports torch and the port only, so that the ranks never load JAX; every
rank runs PyTorch on one thread (the tests run several workers on a few
cores) and returns CPU tensors and floats."""
import dataclasses

import numpy as np
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import build_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import RenderConfig
from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

CPU = torch.device("cpu")
# the train-step case of tests/test_parallel.py's freeze test: mount_low
# at 8x8, depth 2, lr 0.05, these scales
TRAIN_RES, TRAIN_DEPTH, TRAIN_LR = 8, 2, 0.05
TRAIN_SCALES = dict(materials=1.0, light_pos=1.0, camera=0.0, geometry=0.0)
FREEZE = ("geometry", "camera")


def sphere_plane(sd, res):
    """tests/test_whitted_vs_oracle.py::sphere_plane_scene on either
    package's SceneDef: a red sphere over a plane, two lights."""
    sd.set_camera(eye=[0, 1, 5], at=[0, 0, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=res, res_y=res, aperture_ratio=0,
                  focal_ratio=1)
    m0 = sd.add_material([0.8, 0.2, 0.2], 0.9, [1, 1, 1], 0.1, 30, 0, 1)
    sd.add_sphere([0, 0, 0], 1.0, m0)
    m1 = sd.add_material([0.4, 0.4, 0.9], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    sd.add_plane_points([0, -1, 0], [1, -1, 0], [0, -1, -1], m1)
    sd.add_light([5, 5, 5], [1, 1, 1])
    sd.add_light([-4, 6, 2], [0.4, 0.4, 0.6])
    sd.bg_color = np.array([0.1, 0.2, 0.3], np.float32)
    return sd


def render_scenes():
    """(name, scene, config) of the sharded-render cases: mount_low 16x16
    at depth 4 and 2, the sphere and plane at 23x23 (529 pixels: uneven
    shards), the BVH sphere field (n_side 16) at 16x16."""
    mount = build_scene(scenes.mount_scene(res=16), device=CPU)
    return [
        ("mount16", mount, RenderConfig()),
        ("mount16_depth2", mount, RenderConfig(max_depth=2)),
        ("sphere_plane23", build_scene(sphere_plane(SceneDef(), 23),
                                       device=CPU), RenderConfig()),
        ("field16", build_scene(scenes.sphere_field_scene(n_side=16, res=16),
                                device=CPU), RenderConfig()),
    ]


def render_rank(rank, size):
    torch.set_num_threads(1)
    return {name: dist.render_image_sharded(scene, cfg)
            for name, scene, cfg in render_scenes()}


def train_scene():
    return build_scene(scenes.mount_scene(res=TRAIN_RES), device=CPU)


def train_config():
    return RenderConfig(max_depth=TRAIN_DEPTH)


def full_step(target, freeze=()):
    """(loss, leaves) after one ``train_step_full`` of the train case
    against ``target`` on this rank's group."""
    s, loss = dist.train_step_full(
        train_scene(), target, train_config(), TRAIN_LR, None,
        dist.lr_scales(**TRAIN_SCALES), freeze)
    return float(loss), [x.clone() for x in
                         dist.tree_leaves(dist.params_of(s))]


def perturbed_sphere_plane(res=16):
    """tests/test_parallel.py::test_train_step_reduces_loss's start: the
    sphere and plane with every diffuse colour +0.25 (clamped), and the
    unperturbed scene's render as the target."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        render_image,
    )

    scene = build_scene(sphere_plane(SceneDef(), res), device=CPU)
    target = render_image(scene, RenderConfig())
    mats = dataclasses.replace(
        scene.materials,
        diff_color=(scene.materials.diff_color + 0.25).clamp(0.0, 1.0))
    return dataclasses.replace(scene, materials=mats), target


def train_rank(rank, size, target):
    """The sharded train steps: ``full_step`` with zero scales and with
    ``FREEZE``, and the losses of 8 ``train_step``s at lr 2 from
    ``perturbed_sphere_plane``."""
    torch.set_num_threads(1)
    s, tgt = perturbed_sphere_plane()
    losses = []
    for i in range(8):
        s, loss = dist.train_step(s, tgt, RenderConfig(), 2.0,
                                  torch.Generator().manual_seed(i))
        losses.append(float(loss))
    return {"full": full_step(target), "frozen": full_step(target, FREEZE),
            "losses": losses}


def pin_scene():
    """The pin's scene and target: the sphere and plane at 5x5 (25 pixels,
    not a multiple of 2) against its own render."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        render_image,
    )

    scene = build_scene(sphere_plane(SceneDef(), 5), device=CPU)
    return scene, render_image(scene, RenderConfig())


def pin_rank(rank, size):
    torch.set_num_threads(1)
    scene, target = pin_scene()
    _, loss = dist.train_step(scene, target, RenderConfig(), 0.0)
    return float(loss)


def pt_rank(rank, size, res, bounces):
    torch.set_num_threads(1)
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
        glsl_camera,
        glsl_world,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.pathtracer import (
        PTConfig,
    )

    return dist.pt_frame_sharded(glsl_world(device=CPU),
                                 glsl_camera(res, res, device=CPU),
                                 PTConfig(max_bounces=bounces))


def failing_rank(rank, size):
    """Rank 1 raises; rank 0 waits on a collective that never completes."""
    if rank == 1:
        raise ValueError("planted failure on rank 1")
    torch.distributed.all_reduce(torch.ones(1))


def sleeping_rank(rank, size):
    import time

    time.sleep(60)


# ---------------------------------------------------------------------------
# the compiled sharded programs (tests/test_torch_dist_graphs.py)

MODES = ("in_graph", "after_replay")
GATHER_SIZES = (25, 256)
PT_SEED = 5


def _compiled_mode(mode):
    """A fresh stand-in graph cache (tests/test_torch_graphs.FakeGraphs),
    the CPU treated as the card, and the collective inside the captured
    program (``in_graph``) or after its replay (``after_replay``)."""
    from test_torch_graphs import FakeGraphs

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    cache = graphs.GraphCache(FakeGraphs())
    graphs.CACHE = cache
    graphs.on_card = lambda device: True
    dist.collective_in_graph = lambda group=None: mode == "in_graph"
    return cache


def _orbited(scene, alpha=25.0):
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        orbit_eye,
        with_eye,
    )

    cam = scene.camera
    r = float(torch.linalg.vector_norm(cam.eye))
    return dataclasses.replace(
        scene, camera=with_eye(cam, orbit_eye(cam, alpha, 10.0, r)))


def _frames(scene, cfg):
    """Two compiled calls on ``scene`` and one on it orbited, each beside
    the eager sharded call on the same scene."""
    moved = _orbited(scene)
    got = [dist.render_image_sharded(s, cfg) for s in (scene, scene, moved)]
    want = [dist.render_image_sharded_eager(s, cfg)
            for s in (scene, scene, moved)]
    return {"got": got, "want": want}


def _pt_frames(engine, res, bounces):
    """Two compiled path-traced frames from one generator beside two eager
    ones from another in the same state, and both generators' states."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
        glsl_camera,
        glsl_world,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.pathtracer import (
        PTConfig,
    )

    world = glsl_world(device=CPU)
    cam = glsl_camera(res, res, device=CPU)
    cfg = PTConfig(max_bounces=bounces)
    g, e = (torch.Generator().manual_seed(PT_SEED) for _ in range(2))
    got = [dist.pt_frame_sharded(world, cam, cfg, None, g, engine)
           for _ in range(2)]
    want = [dist.pt_frame_sharded_eager(world, cam, cfg, None, e, engine)
            for _ in range(2)]
    return {"got": got, "want": want, "states": (g.get_state(),
                                                 e.get_state())}


def _steps(target):
    """Two chained compiled train_step_full steps of the train case beside
    two eager ones, and one compiled train_step beside the eager one:
    [(loss, leaves)] each."""
    cfg, scales = train_config(), dist.lr_scales(**TRAIN_SCALES)
    full = dist.make_train_step(dist.train_step_full, cfg, TRAIN_LR,
                                scales=scales)

    def chain(step):
        out, s = [], train_scene()
        for _ in range(2):
            s, loss = step(s, target)
            out.append((float(loss), [x.clone() for x in
                                      dist.tree_leaves(dist.params_of(s))]))
        return out

    mats = dist.make_train_step(dist.train_step, cfg, TRAIN_LR)

    def mat_step(step):
        s, loss = step(train_scene(), target)
        return float(loss), [x.clone() for x in
                             dist.tree_leaves(dist.params_of(s))]

    return {"got": chain(full),
            "want": chain(lambda s, t: dist.train_step_full(
                s, t, cfg, TRAIN_LR, None, scales)),
            "mat_got": mat_step(mats),
            "mat_want": mat_step(lambda s, t: dist.train_step(s, t, cfg,
                                                              TRAIN_LR))}


def _gathers(rank, size):
    """For each n of GATHER_SIZES, over this rank's slice of a seeded
    [n, 3] tensor: the all-gather's and the all_reduce form's results, and
    gather_rows' (the all-gather on gloo's CPU tensors)."""
    out = {}
    for n in GATHER_SIZES:
        full = torch.randn(n, 3, generator=torch.Generator().manual_seed(n))
        a, b = dist.shard_bounds(n, size, rank)
        part = full[a:b]
        out[n] = {"full": full, "all_gather": dist.all_gather_rows(part, n),
                  "all_reduce": dist.all_reduce_rows(part, n, a),
                  "gather_rows": dist.gather_rows(part, n, a)}
    return out


def compiled_rank(rank, size, target):
    """Every compiled sharded program of the port in both modes (MODES)
    on this rank, through the stand-in graphs, beside the eager sharded
    calls; the gathers; the process's capture mode in the group; and the
    names and replays of the graphs each mode captured."""
    torch.set_num_threads(1)
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    mount = build_scene(scenes.mount_scene(res=16), device=CPU)
    out = {"gathers": _gathers(rank, size),
           "capture_mode": graphs.CACHE.capture_mode}
    for mode in MODES:
        cache = _compiled_mode(mode)
        out[mode] = {
            "megakernel": _frames(mount, RenderConfig(engine="megakernel")),
            "sweep": _frames(mount, RenderConfig()),
            "pt": _pt_frames("megakernel", 16, 3),
            "pt_plain": _pt_frames("plain", 8, 2),
            "steps": _steps(target),
            "graphs": sorted((k[0], g.replays)
                             for k, g in cache.graphs.items()),
            "captures": cache.captures}
    return out
