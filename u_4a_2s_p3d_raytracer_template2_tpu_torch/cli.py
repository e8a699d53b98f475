"""Command-line entry point of the port: the ``render`` and ``pathtrace``
subcommands of ``u_4a_2s_p3d_raytracer_template2_tpu/cli.py``.

Usage::

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli render \\
        --builtin mount --res 512 --engine megakernel -o mount.png
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli render \\
        --builtin mount_dist --soft-shadow --fuzzy-reflection \\
        --skybox --env skybox_dir --engine megakernel -o mount_dist.png
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli render \\
        scene.p3f --engine megakernel -o scene.png
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli pathtrace \\
        --res 512 --frames 16 --checkpoint pt.npz -o pt.png

Both run on the CUDA card unless ``--device cpu`` is given; without a card
they exit with an error rather than fall back to the CPU.

``render`` renders a ``.p3f`` file or a built-in scene (mount_low, mount_low
in distribution mode with spp 4 and an 8-pixel lens, the sphere field or
the random scene, with the scene's accelerator unless ``--accel`` says
otherwise), writes the PNG, and prints the frame time and
the rate in Mrays/s (primary + shadow rays of every AA sample). A scene's
``spp`` turns on anti-aliasing and depth of field
(``RenderConfig.with_scene_flags``), as ``--spp`` does; the stochastic
features draw from a ``torch.Generator`` seeded by ``--seed``. On a CUDA
device the time is the median of CUDA-event frame times; on the CPU it is
one host wall-clock render, labelled as such.

``pathtrace`` accumulates progressive 1-spp frames of the GLSL world,
optionally resuming from and saving a checkpoint, and writes the
gamma-corrected PNG.
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
                       accel_impl=args.accel_impl).with_scene_flags(scene)
    if args.spp is not None:
        cfg = dataclasses.replace(cfg, spp=args.spp,
                                  anti_aliasing=args.spp > 0,
                                  depth_of_field=args.spp > 0)
    return cfg


def cmd_render(args) -> None:
    from .core import constants as C
    from .core.build import build_scene
    from .io.image import save_png
    from .models.whitted import render_image
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
    print(f"Resolution {cam.res_x}x{cam.res_y}, {scene.n_objects} objects, "
          f"{scene.n_lights} lights, depth {cfg.max_depth}, engine "
          f"{cfg.engine}, accel {accel} ({cfg.accel_impl}), {samples} "
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="u_4a_2s_p3d_raytracer_template2_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("scene", nargs="?", help=".p3f scene file")
    pr.add_argument("--builtin",
                    choices=["mount", "mount_dist", "spheres", "random"],
                    help="a built-in scene (default mount when no file is "
                    "given); mount_dist is mount_low in distribution mode")
    pr.add_argument("--accel", type=int, default=None,
                    help="0 none, 1 grid, 2 bvh (default: scene's)")
    pr.add_argument("--accel-impl", dest="accel_impl", default="auto",
                    choices=["auto", "packets", "clusters", "perray",
                             "brute"],
                    help="BVH- and grid-mode traversal: auto, packets and "
                    "clusters walk the BVH (the CUDA walk on a CUDA device), "
                    "brute tests every primitive; perray is not ported yet")
    pr.add_argument("--res", type=int, default=None,
                    help="square resolution (default: scene's)")
    pr.add_argument("--spp", type=int, default=None,
                    help="AA grid side: spp*spp jittered samples a pixel, "
                    "with depth of field (default: the scene's spp)")
    pr.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generator the samples come from")
    pr.add_argument("--soft-shadow", action="store_true")
    pr.add_argument("--fuzzy-reflection", action="store_true")
    pr.add_argument("--motion-blur", action="store_true")
    pr.add_argument("--skybox", action="store_true",
                    help="sample the env cubemap on miss")
    pr.add_argument("--env", default=None,
                    help="skybox directory of six faces (right, left, top, "
                    "bottom, front, back .png/.jpg), over the scene's env")
    pr.add_argument("--depth", type=int, default=4)
    pr.add_argument("--engine", choices=["sweep", "megakernel"],
                    default="sweep",
                    help="megakernel = the CUDA kernel on a CUDA device, "
                    "its plain version on the CPU")
    pr.add_argument("--fresnel", default="schlick",
                    choices=["schlick", "reference_schlick",
                             "reference_exact"])
    pr.add_argument("--refraction", default="reference",
                    choices=["reference", "physical"])
    pr.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    pr.add_argument("-o", "--output", default="RT_Output.png")
    pr.set_defaults(fn=cmd_render)

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

    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device is available; pass "
                "--device cpu to run on the CPU")
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
