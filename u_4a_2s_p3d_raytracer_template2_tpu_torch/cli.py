"""Command-line entry point of the port: the ``render``, ``fit``,
``pathtrace``, ``orbit``, ``view`` and ``live`` subcommands of
``u_4a_2s_p3d_raytracer_template2_tpu/cli.py``.

Usage::

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli render \\
        --builtin mount --res 512 --engine megakernel -o mount.png
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli render \\
        --builtin mount_dist --soft-shadow --fuzzy-reflection \\
        --skybox --env skybox_dir --engine megakernel -o mount_dist.png
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli render \\
        scene.p3f --engine megakernel -o scene.png
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli fit \\
        --builtin mount --res 512 --steps 3 --fit lights --lr 1e4
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli pathtrace \\
        --res 512 --frames 16 --checkpoint pt.npz -o pt.png
    torchrun --standalone --nproc_per_node 2 \\
        -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli fit \\
        --builtin mount --res 16 --steps 3 --device cpu
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli orbit \\
        --builtin mount --res 512 --frames 8 -o orbit_%d.png
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli view \\
        --builtin mount --res 512 --orbit-frames 8 --still-frames 4
    printf 'aw  a q' | python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli \\
        live --builtin mount --res 512 --engine megakernel

All run on the CUDA card unless ``--device cpu`` is given; without a card
they exit with an error rather than fall back to the CPU. On the card each
frame and each train step is one compiled program (``utils/graphs.py``):
captured as a CUDA graph at its first call and replayed after, so a
viewer's orbit captures once; the viewers and ``fit`` print the captures
at the end.

``render`` renders a ``.p3f`` file or a built-in scene (mount_low, mount_low
in distribution mode with spp 4 and an 8-pixel lens, the sphere field or
the random scene, with the scene's accelerator unless ``--accel`` says
otherwise) on the engine its summary line names (``--engine megakernel``
renders a scene over the kernel's envelope on the wavefront), writes the
PNG, and prints the frame time and
the rate in Mrays/s (primary + shadow rays of every AA sample). A scene's
``spp`` turns on anti-aliasing and depth of field
(``RenderConfig.with_scene_flags``), as ``--spp`` does; the stochastic
features draw from a ``torch.Generator`` seeded by ``--seed``. On a CUDA
device the time is the median of CUDA-event frame times; on the CPU it is
one host wall-clock render, labelled as such.

``fit`` perturbs the scene and recovers it by gradient descent
(parallel/dist.py, ``cmd_fit``), printing the loss and the offset from
the truth a step. Under torchrun (``WORLD_SIZE`` above 1) every process
joins the group (``dist.initialize_multihost``: gloo on the CPU, NCCL on
``cuda:LOCAL_RANK``, one process a card), the steps shard the pixels over
it, each a CUDA graph a rank with the gradients' all_reduce inside it on
NCCL, and rank 0 alone prints.

``pathtrace`` accumulates progressive 1-spp frames of the GLSL world,
optionally resuming from and saving a checkpoint, and writes the
gamma-corrected PNG.

``orbit`` writes turntable frames; ``view`` renders while the camera
orbits, printing each frame's time, FPS and Mrays/s, then accumulates
jittered frames with the camera still; ``live`` reads keys from stdin (a
terminal or a pipe) and re-renders on each, drawing the frame in the
terminal (``--preview-cols``, ``io/image.preview_u8`` and
``ansi_halfblock``). Their frames are ``render_image`` with ``--tile-rows``
image rows a tile (0: the whole frame at once); their times are host wall
clock around a frame that ends in a device synchronise.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch


_DEVICE_HELP = ("torch device to run on (default cuda; the CPU only when "
                "asked for with --device cpu)")


def _scene_def(args):
    from .io.p3f import parse_p3f
    from .models import scenes

    if args.scene and not args.builtin:
        if not os.path.exists(args.scene):
            raise SystemExit(f"Error opening P3F file: {args.scene}")
        sd = parse_p3f(args.scene)
    else:
        sd = {"mount": scenes.mount_scene,
              "mount_dist": scenes.mount_distribution_scene,
              "spheres": scenes.sphere_field_scene,
              "random": scenes.random_scene}[args.builtin or "mount"]()
    if args.res:
        sd.camera["res_x"] = sd.camera["res_y"] = args.res
    if args.env is not None:
        sd.skybox_dir = args.env
    return sd


def _config(args, scene):
    """The JAX CLI's config (cli.py:55-73 there): the flags, the scene's
    spp coupling, and ``--spp`` over it."""
    import dataclasses

    from .core.types import RenderConfig

    cfg = RenderConfig(max_depth=args.depth, engine=args.engine,
                       soft_shadow=args.soft_shadow,
                       fuzzy_reflection=args.fuzzy_reflection,
                       motion_blur=args.motion_blur, use_skybox=args.skybox,
                       fresnel_mode=args.fresnel,
                       refraction_mode=args.refraction,
                       accel_impl=args.accel_impl,
                       wavefront_capacity=args.capacity
                       ).with_scene_flags(scene)
    if args.spp is not None:
        cfg = dataclasses.replace(cfg, spp=args.spp,
                                  anti_aliasing=args.spp > 0,
                                  depth_of_field=args.spp > 0)
    return cfg


def cmd_render(args) -> None:
    from .core import constants as C
    from .core.build import build_scene
    from .io.image import save_png
    from .models.whitted import engine_of, render_image
    from .utils.timing import frame_ms, mrays_per_s

    dev = torch.device(args.device)
    scene = build_scene(_scene_def(args), device=dev, accel=args.accel)
    cfg = _config(args, scene)
    cam = scene.camera
    accel = {C.ACCEL_NONE: "none", C.ACCEL_GRID: "grid",
             C.ACCEL_BVH: "bvh"}[scene.accel_type]
    samples = max(cfg.spp, 1) ** 2 if cfg.anti_aliasing else 1
    sky = (f"skybox {tuple(scene.skybox.shape)} {scene.skybox.dtype}"
           if scene.has_skybox else "no skybox")
    engine = engine_of(scene, cfg)
    if engine != cfg.engine:
        engine += (f" (engine {cfg.engine} asked for: {scene.n_objects} "
                   f"objects at depth {cfg.max_depth} are outside its "
                   "envelope)")
    if engine.startswith("wavefront"):
        engine += f", capacity {cfg.wavefront_capacity:g}"
    print(f"Resolution {cam.res_x}x{cam.res_y}, {scene.n_objects} objects, "
          f"{scene.n_lights} lights, depth {cfg.max_depth}, engine "
          f"{engine}, accel {accel} ({cfg.accel_impl}), {samples} "
          f"samples a pixel (AA {cfg.anti_aliasing}, DoF "
          f"{cfg.depth_of_field}, soft shadow {cfg.soft_shadow}, fuzzy "
          f"{cfg.fuzzy_reflection}, motion blur {cfg.motion_blur}, use "
          f"skybox {cfg.use_skybox}), {sky}, device {scene.device}")

    t0 = time.perf_counter()
    img = render_image(scene, cfg,
                       torch.Generator(device=dev).manual_seed(args.seed))
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
        ms = frame_ms(scene, cfg)
        label = f"median CUDA-event frame time on {torch.cuda.get_device_name(scene.device)}"
    else:
        ms = (time.perf_counter() - t0) * 1e3
        label = "one render, host wall clock, cpu"
    print(f"frame {ms:.3f} ms ({label}); "
          f"{mrays_per_s(scene, ms, cfg):.2f} Mrays/s (primary+shadow)")
    print(f"image mean {float(img.mean()):.5f}, std {float(img.std()):.5f}")
    save_png(args.output, img)
    print(f"Image file created: {args.output}")


def cmd_fit(args) -> None:
    """Inverse rendering (JAX cli.py:120-222 there): the target is the
    scene's own render; the fit starts from a perturbed scene and runs
    ``--steps`` steps of parallel/dist.py's train steps (compiled by
    ``make_train_step``: one CUDA graph replay a step on each card, its
    all_reduce inside the graph under torchrun with NCCL; eager on the
    CPU), printing the loss and the distance to the
    truth a step. ``--fit materials``: the diffuse
    colours +0.3 (``train_step``); ``lights`` / ``all``: light 0 moved by
    (1, -0.7, 0.5), fitting its position (and with ``all`` the camera);
    ``geometry``: the largest sphere's centre moved by 0.4 r along (0.8,
    -0.5, 0.6), fitting that row of the primitive table, on brute force
    (an accelerator's tables keep the built geometry)."""
    import dataclasses

    from .core import constants as C
    from .core.build import build_scene, with_prim_params
    from .models.whitted import engine_of
    from .parallel.dist import (
        initialize_multihost,
        leave_group,
        lr_scales,
        make_train_step,
        rank_device,
        render_image_sharded,
        train_step,
        train_step_full,
        world,
    )

    dev = torch.device(args.device)
    n_procs = int(os.environ.get("WORLD_SIZE", "1"))
    if n_procs > 1:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dev = rank_device(dev, backend)
        initialize_multihost(num_processes=n_procs, device=dev,
                             backend=backend)
    rank, size = world()
    say = print if rank == 0 else (lambda *a, **k: None)
    scene = build_scene(_scene_def(args), device=dev, accel=args.accel)
    cfg = _config(args, scene)
    if args.fit == "geometry" and scene.accel_type != C.ACCEL_NONE:
        say("note: scene declares an accelerator; geometry fit forces "
            "accel_impl='brute' (accel tables hold the built geometry "
            "during a fit)")
        cfg = dataclasses.replace(cfg, accel_impl="brute")
    cam = scene.camera
    say(f"fit {args.fit}: {cam.res_x}x{cam.res_y}, {scene.n_objects} "
        f"objects, depth {cfg.max_depth}, engine {engine_of(scene, cfg)}, "
        f"lr {args.lr:g}, {args.steps} steps, device {scene.device}, "
        f"{size} rank(s)")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    target = render_image_sharded(scene, cfg, None, gen(args.seed))
    t0 = time.perf_counter()
    if args.fit == "materials":
        mats = dataclasses.replace(
            scene.materials,
            diff_color=(scene.materials.diff_color + 0.3).clamp(0.0, 1.0))
        s = dataclasses.replace(scene, materials=mats)
        step = make_train_step(train_step, cfg, args.lr)
        for i in range(args.steps):
            s, loss = step(s, target, gen(i))
            say(f"step {i}: loss {float(loss):.6f}")
    elif args.fit == "geometry":
        true_params = scene.prims.params
        sph = torch.nonzero(scene.prims.ptype == C.SPHERE)[:, 0]
        # the largest sphere: the most screen coverage, the strongest
        # smooth gradient
        row = (int(sph[torch.argmax(true_params[sph, 3])]) if len(sph)
               else 0)
        r = max(float(true_params[row, 3]), 1e-3)
        delta = torch.zeros_like(true_params)
        # ~40% of the radius, so that the sphere still overlaps its true
        # silhouette (the smooth gradient has no silhouette term)
        delta[row, 0:3] = torch.tensor([0.8, -0.5, 0.6], device=dev) * (
            0.4 * r)
        s = with_prim_params(scene, true_params + delta)
        mask = torch.zeros((true_params.shape[0], 1), device=dev)
        mask[row] = 1.0
        sc = dataclasses.replace(
            lr_scales(materials=0.0, light_pos=0.0, light_color=0.0,
                      camera=0.0, geometry=0.0), prim_params=mask)
        step = make_train_step(train_step_full, cfg, args.lr, scales=sc)
        for i in range(args.steps):
            s, loss = step(s, target, gen(i))
            d = float(torch.linalg.vector_norm(
                s.prims.params[row, 0:3] - true_params[row, 0:3]))
            say(f"step {i}: loss {float(loss):.6f}  center offset {d:.4f}")
            if i == 0 and float(loss) < 1e-7:
                say("note: displaced sphere does not affect the image at "
                    "this resolution — try a higher --res")
    else:
        true_pos = scene.lights.position
        delta = torch.zeros_like(true_pos)
        delta[0] = torch.tensor([1.0, -0.7, 0.5], device=dev)
        s = dataclasses.replace(scene, lights=dataclasses.replace(
            scene.lights, position=true_pos + delta))
        sc = lr_scales(materials=0.0, light_pos=1.0, light_color=0.0,
                       camera=1.0 if args.fit == "all" else 0.0)
        step = make_train_step(train_step_full, cfg, args.lr, scales=sc)
        for i in range(args.steps):
            s, loss = step(s, target, gen(i))
            d = float(torch.linalg.vector_norm(s.lights.position - true_pos))
            say(f"step {i}: loss {float(loss):.6f}  light offset {d:.3f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    say(f"{args.steps} steps in {time.perf_counter() - t0:.3f} s (host "
        f"wall clock, {dev.type}, {size} rank(s))")
    _say_captures(say, dev)
    if n_procs > 1:
        leave_group()


def cmd_pathtrace(args) -> None:
    """Progressive Monte Carlo path tracing of the GLSL showcase world
    (models/pathtracer.py, models/glsl_scene.py)."""
    from .io.image import save_png
    from .models import pathtracer as pt
    from .models import pt_megakernel as mk
    from .models.glsl_scene import glsl_camera, glsl_world
    from .utils import checkpoint

    dev = torch.device(args.device)
    scene = glsl_world(device=dev,
                       showcase_fuzzy_reflections=args.fuzzy_reflection)
    res = args.res
    cam = glsl_camera(res, res, showcase_dof=args.dof, device=dev)
    cfg = pt.PTConfig(russian_roulette=args.russian_roulette)
    frame_fn = mk.make_render_frame(scene, cam, cfg, args.pt_engine)
    print(f"engine: {args.pt_engine}, device {dev}")

    t0 = time.perf_counter()
    acc = None
    if args.resume and os.path.exists(checkpoint.npz_path(args.resume)):
        acc = checkpoint.restore(args.resume,
                                 pt.make_accumulator(res, res, device=dev))
        print(f"resumed at {float(acc.count):.0f} spp")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    acc = pt.render_progressive(scene, cam, cfg, gen, args.frames, acc=acc,
                                frame_fn=frame_fn)
    count = float(acc.count)  # waits for the device
    dt = time.perf_counter() - t0
    print(f"{count:.0f} spp accumulated in {dt:.1f}s ({res}x{res})")
    if args.checkpoint:
        checkpoint.save(args.checkpoint, acc)
        print(f"checkpoint saved: {args.checkpoint}")
    save_png(args.output, pt.to_image(acc))
    print(f"Image file created: {args.output}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _say_captures(say, dev) -> None:
    """Print how many programs were captured as CUDA graphs (utils/graphs.py)
    on the card."""
    if dev.type == "cuda":
        from .utils import graphs

        say(f"CUDA graphs captured: {graphs.CACHE.captures}")


def _orbit_scene(scene, alpha, beta, r):
    """``scene`` with its camera on the orbit (``ops/camera.orbit_eye``)."""
    import dataclasses

    from .ops.camera import orbit_eye, with_eye

    cam = scene.camera
    return dataclasses.replace(
        scene, camera=with_eye(cam, orbit_eye(cam, alpha, beta, r)))


def cmd_orbit(args) -> None:
    """Turntable frames around the origin at pitch ``--beta``: the
    headless counterpart of the reference's mouse-orbit viewer
    (main.cpp:357-433; JAX cli.py:279-307). A ``%d`` in ``-o`` takes the
    frame number, else ``_NNN`` goes before the extension."""
    from .core.build import build_scene
    from .io.image import save_png
    from .models.whitted import render_image

    dev = torch.device(args.device)
    scene = build_scene(_scene_def(args), device=dev, accel=args.accel)
    cfg = _config(args, scene)
    r = float(torch.linalg.vector_norm(scene.camera.eye))
    for i in range(args.frames):
        alpha = 360.0 * i / args.frames
        img = render_image(_orbit_scene(scene, alpha, args.beta, r), cfg,
                           torch.Generator(device=dev).manual_seed(i),
                           tile_rows=args.tile_rows)
        path = (args.output.replace("%d", str(i)) if "%d" in args.output
                else f"{args.output.rsplit('.', 1)[0]}_{i:03d}.png")
        save_png(path, img)
        print(f"frame {i}: {path}")
    _say_captures(print, dev)


def cmd_view(args) -> None:
    """A viewer session without a window (the reference's idle-func
    viewer, main.cpp:835-868; JAX cli.py:310-384): frames while the camera
    orbits ``--sweep`` degrees, each with its time, FPS and Mrays/s
    (main.cpp:280-289), then ``--still-frames`` jittered frames
    accumulated with the camera still (P3D_RT.glsl:345-365); the orbit
    frames, rendered without AA, are not blended in."""
    import dataclasses

    from .core.build import build_scene
    from .io.image import save_png
    from .models.whitted import render_image

    dev = torch.device(args.device)
    scene = build_scene(_scene_def(args), device=dev, accel=args.accel)
    cfg = _config(args, scene)
    cam0 = scene.camera
    rays_per_frame = cam0.res_x * cam0.res_y * (1 + scene.n_lights)
    r = float(torch.linalg.vector_norm(cam0.eye))

    def frame(s, use_cfg, seed):
        img = render_image(s, use_cfg,
                           torch.Generator(device=dev).manual_seed(seed),
                           tile_rows=args.tile_rows)
        _sync(dev)
        return img

    # a warm-up frame (kernel loading), outside the readout, as the
    # reference's first frame pays the scene build
    img = frame(_orbit_scene(scene, 0.0, args.beta, r), cfg, 0)
    print(f"session: {cam0.res_x}x{cam0.res_y}, {scene.n_objects} objects, "
          f"orbit {args.orbit_frames} frames over {args.sweep} deg, then "
          f"accumulate {args.still_frames} frames, device {dev}")
    for i in range(args.orbit_frames):
        alpha = args.sweep * (i + 1) / max(args.orbit_frames, 1)
        t0 = time.perf_counter()
        img = frame(_orbit_scene(scene, alpha, args.beta, r), cfg, 0)
        dt = time.perf_counter() - t0
        print(f"orbit frame {i}: alpha={alpha:7.2f}  {dt * 1e3:7.1f} ms  "
              f"{1.0 / dt:6.2f} FPS  {rays_per_frame / dt / 1e6:7.2f} Mrays/s")

    acc_cfg = (dataclasses.replace(cfg, anti_aliasing=True,
                                   spp=max(cfg.spp, 1))
               if args.still_frames else cfg)
    still = _orbit_scene(scene, args.sweep, args.beta, r)
    acc = torch.zeros_like(img)
    for i in range(args.still_frames):
        t0 = time.perf_counter()
        img = frame(still, acc_cfg, 1 + i)
        acc = acc + img
        _sync(dev)
        dt = time.perf_counter() - t0
        print(f"still frame {i}: {i + 1} samples  {dt * 1e3:7.1f} ms  "
              f"{1.0 / dt:6.2f} FPS")
    save_png(args.output, acc / args.still_frames if args.still_frames
             else img)
    print(f"Image file created: {args.output}")
    _say_captures(print, dev)


def _read_keys():
    """Single keypresses from stdin: on a terminal in cbreak mode, each
    key as it is pressed; from a pipe every character of every line, the
    newlines skipped (``printf 'ad+q' | ... live``)."""
    if sys.stdin.isatty():
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while ch := sys.stdin.read(1):
                yield ch
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
    else:
        while ch := sys.stdin.read(1):
            if ch not in "\r\n":
                yield ch


def cmd_live(args) -> None:
    """The reference's keyboard and mouse loop on stdin (JAX
    cli.py:419-530): processKeys (main.cpp:327-349), the yaw/pitch orbit
    with the ±85° pitch clamp (main.cpp:395-421) and the 0.1 zoom step
    with its 0.1 radius floor (main.cpp:425-431). Each key re-renders,
    draws the frame in the terminal (``--preview-cols``; 0 draws nothing)
    and prints the title bar's FPS and Mrays/s (main.cpp:280-289).

    Keys: a/d yaw -/+5°, w/s pitch +/-5°, +/- zoom in/out, SPACE
    accumulates one jittered frame (a camera move resets the sum, the GLSL
    iFrame reset, P3D_RT.glsl:345-365), r resets the camera, c prints its
    coordinates, q or ESC quits and writes the PNG (the mean of the
    accumulated frames, else the last frame)."""
    import dataclasses
    import math

    from .core.build import build_scene
    from .io.image import ansi_halfblock, preview_u8, save_png
    from .models.whitted import render_image

    dev = torch.device(args.device)
    scene = build_scene(_scene_def(args), device=dev, accel=args.accel)
    cfg = _config(args, scene)
    cam0 = scene.camera
    rays_per_frame = cam0.res_x * cam0.res_y * (1 + scene.n_lights)
    acc_cfg = dataclasses.replace(cfg, anti_aliasing=True,
                                  spp=max(cfg.spp, 1))

    def spherical_of_eye():
        # the reference's 'r' handler (main.cpp:334-341)
        ex, ey, ez = cam0.eye.tolist()
        rr = math.sqrt(ex * ex + ey * ey + ez * ez)
        return (math.degrees(math.atan2(ex, ez)),
                math.degrees(math.asin(ey / rr)), rr)

    alpha, beta, r = spherical_of_eye()
    acc, n_acc = None, 0

    def render(use_cfg, seed):
        t0 = time.perf_counter()
        img = render_image(_orbit_scene(scene, alpha, beta, r), use_cfg,
                           torch.Generator(device=dev).manual_seed(seed),
                           tile_rows=args.tile_rows)
        _sync(dev)
        dt = time.perf_counter() - t0
        if args.preview_cols > 0:
            print(ansi_halfblock(preview_u8(img, args.preview_cols)),
                  flush=True)
        print(f"alpha={alpha:7.2f} beta={beta:6.2f} r={r:6.2f}  "
              f"{dt * 1e3:7.1f} ms  {1.0 / dt:6.2f} FPS  "
              f"{rays_per_frame / dt / 1e6:7.2f} Mrays/s", flush=True)
        return img

    print(f"live: {cam0.res_x}x{cam0.res_y}, {scene.n_objects} objects, "
          f"device {dev}; keys: a/d yaw, w/s pitch, +/- zoom, SPACE "
          "accumulate, r reset, c coords, q quit", flush=True)
    img = render(cfg, 0)
    for ch in _read_keys():
        if ch in ("q", "\x1b"):          # ESC, main.cpp:331
            break
        if ch == "c":                     # main.cpp:343-347
            ex, ey, ez = _orbit_scene(scene, alpha, beta,
                                      r).camera.eye.tolist()
            print(f"Camera Spherical Coordinates ({r:f}, {beta:f}, "
                  f"{alpha:f})")
            print(f"Camera Cartesian Coordinates ({ex:f}, {ey:f}, {ez:f})",
                  flush=True)
            continue
        if ch == " ":
            n_acc += 1
            img = render(acc_cfg, n_acc)
            acc = img if acc is None else acc + img
            print(f"  accumulated {n_acc} samples", flush=True)
            continue
        if ch == "r":
            alpha, beta, r = spherical_of_eye()
        elif ch == "a":
            alpha -= 5.0
        elif ch == "d":
            alpha += 5.0
        elif ch == "w":
            beta = min(beta + 5.0, 85.0)   # pitch clamp, main.cpp:402-405
        elif ch == "s":
            beta = max(beta - 5.0, -85.0)
        elif ch == "+":
            r = max(r - 0.1, 0.1)          # radius floor, main.cpp:426-427
        elif ch == "-":
            r += 0.1
        else:
            continue
        acc, n_acc = None, 0
        img = render(cfg, 0)
    save_png(args.output, acc / n_acc if acc is not None else img)
    print(f"Image file created: {args.output}")
    _say_captures(print, dev)


def _scene_args(p) -> None:
    """The arguments of a Whitted scene and config, shared by render, fit
    and the viewers (the JAX CLI's ``common``, cli.py:532-566 there)."""
    p.add_argument("scene", nargs="?", help=".p3f scene file")
    p.add_argument("--builtin",
                   choices=["mount", "mount_dist", "spheres", "random"],
                   help="a built-in scene (default mount when no file is "
                   "given); mount_dist is mount_low in distribution mode")
    p.add_argument("--accel", type=int, default=None,
                   help="0 none, 1 grid, 2 bvh (default: scene's)")
    p.add_argument("--accel-impl", dest="accel_impl", default="auto",
                   choices=["auto", "packets", "clusters", "perray",
                            "brute"],
                   help="BVH- and grid-mode traversal: auto, packets and "
                   "clusters walk the BVH (the CUDA walk on a CUDA device), "
                   "brute tests every primitive, perray walks the "
                   "reference's median BVH or grid DDA (its CUDA kernels on "
                   "a CUDA device)")
    p.add_argument("--res", type=int, default=None,
                   help="square resolution (default: scene's)")
    p.add_argument("--spp", type=int, default=None,
                   help="AA grid side: spp*spp jittered samples a pixel, "
                   "with depth of field (default: the scene's spp)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the torch.Generator the samples come from")
    p.add_argument("--soft-shadow", action="store_true")
    p.add_argument("--fuzzy-reflection", action="store_true")
    p.add_argument("--motion-blur", action="store_true")
    p.add_argument("--skybox", action="store_true",
                   help="sample the env cubemap on miss")
    p.add_argument("--env", default=None,
                   help="skybox directory of six faces (right, left, top, "
                   "bottom, front, back .png/.jpg), over the scene's env")
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--engine", choices=["sweep", "wavefront", "megakernel"],
                   default="sweep",
                   help="wavefront = the compacted queue; megakernel = the "
                   "CUDA kernel on a CUDA device, its plain version on the "
                   "CPU, and the wavefront on scenes over 256 objects or "
                   "depth 8")
    p.add_argument("--capacity", type=float, default=1.0,
                   help="the wavefront's queue, as a share of the primary "
                   "rays (children beyond it are dropped)")
    p.add_argument("--fresnel", default="schlick",
                   choices=["schlick", "reference_schlick",
                            "reference_exact"])
    p.add_argument("--refraction", default="reference",
                   choices=["reference", "physical"])
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="u_4a_2s_p3d_raytracer_template2_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene to PNG")
    _scene_args(pr)
    pr.add_argument("-o", "--output", default="RT_Output.png")
    pr.set_defaults(fn=cmd_render)

    pf = sub.add_parser("fit", help="inverse-rendering demo")
    _scene_args(pf)
    pf.add_argument("--steps", type=int, default=10)
    pf.add_argument("--lr", type=float, default=1.0)
    pf.add_argument("--fit", default="materials",
                    choices=["materials", "lights", "geometry", "all"],
                    help="parameter groups to optimize (lights, geometry "
                    "and all use train_step_full; mount_low's far light "
                    "wants an lr near 1e4, its glass sphere's centre 0.3 "
                    "at 128x128)")
    pf.set_defaults(fn=cmd_fit)

    pp = sub.add_parser("pathtrace",
                        help="progressive Monte Carlo path tracing")
    pp.add_argument("--res", type=int, default=256)
    pp.add_argument("--frames", type=int, default=16,
                    help="1-spp frames to accumulate")
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--dof", action="store_true")
    pp.add_argument("--fuzzy-reflection", action="store_true")
    pp.add_argument("--russian-roulette", action="store_true")
    pp.add_argument("--pt-engine", choices=("plain", "megakernel"),
                    default="megakernel",
                    help="megakernel = the CUDA kernel on a CUDA device, its "
                    "plain version on the CPU; plain = the PyTorch "
                    "integrator")
    pp.add_argument("--checkpoint", help="save accumulation state here")
    pp.add_argument("--resume", help="resume accumulation state from here")
    pp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    pp.add_argument("-o", "--output", default="PT_Output.png")
    pp.set_defaults(fn=cmd_pathtrace)

    def viewer(name, help, output, fn):
        sp = sub.add_parser(name, help=help)
        _scene_args(sp)
        sp.add_argument("--tile-rows", type=int, default=0,
                        help="image rows a tile of a frame (default 0: the "
                        "whole frame at once)")
        sp.add_argument("-o", "--output", default=output)
        sp.set_defaults(fn=fn)
        return sp

    pv = viewer("view", "viewer session: frames while the camera orbits "
                "with an FPS readout, then still-camera accumulation",
                "View_Output.png", cmd_view)
    pv.add_argument("--orbit-frames", type=int, default=8,
                    help="frames rendered while the camera orbits")
    pv.add_argument("--still-frames", type=int, default=4,
                    help="jittered frames accumulated once the camera stops")
    pv.add_argument("--sweep", type=float, default=90.0,
                    help="total orbit sweep in degrees")
    pv.add_argument("--beta", type=float, default=20.0)

    pl = viewer("live", "terminal viewer: a half-block image a frame and a "
                "stdin key loop (a/d/w/s orbit, +/- zoom, SPACE accumulate, "
                "r reset, c coords, q quit)", "Live_Output.png", cmd_live)
    pl.add_argument("--preview-cols", type=int, default=80,
                    help="terminal preview width in characters (0 disables "
                    "the preview)")

    po = viewer("orbit", "camera-orbit turntable frames", "orbit.png",
                cmd_orbit)
    po.add_argument("--frames", type=int, default=8)
    po.add_argument("--beta", type=float, default=20.0)

    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device is available; pass "
                "--device cpu to run on the CPU")
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
