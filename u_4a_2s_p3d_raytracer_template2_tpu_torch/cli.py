"""Command-line entry point of the port: the ``render`` and ``pathtrace``
subcommands of ``u_4a_2s_p3d_raytracer_template2_tpu/cli.py``.

Usage::

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli render \\
        --builtin mount --res 512 --engine megakernel -o mount.png
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli pathtrace \\
        --res 512 --frames 16 --checkpoint pt.npz -o pt.png

Both run on the CUDA card unless ``--device cpu`` is given; without a card
they exit with an error rather than fall back to the CPU.

``render`` renders a built-in scene, writes the PNG, and prints the frame
time and the rate in Mrays/s (primary + shadow rays). On a CUDA device the
time is the median of CUDA-event frame times; on the CPU it is one host
wall-clock render, labelled as such.

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


def cmd_render(args) -> None:
    from .core import constants as C
    from .core.build import build_scene
    from .core.types import RenderConfig
    from .io.image import save_png
    from .models import scenes
    from .models.whitted import render_image
    from .utils.timing import frame_ms, mrays_per_s

    make_scene = {"mount": scenes.mount_scene,
                  "spheres": scenes.sphere_field_scene}[args.builtin]
    sd = make_scene(res=args.res)
    # the port traces brute force only (accelerators: ROADMAP.md queue 1)
    scene = build_scene(sd, device=torch.device(args.device),
                        accel=C.ACCEL_NONE)
    cfg = RenderConfig(max_depth=args.depth, engine=args.engine,
                       fresnel_mode=args.fresnel,
                       refraction_mode=args.refraction)
    cam = scene.camera
    print(f"Resolution {cam.res_x}x{cam.res_y}, {scene.n_objects} objects, "
          f"{scene.n_lights} lights, depth {cfg.max_depth}, engine "
          f"{cfg.engine}, device {scene.device}")

    t0 = time.perf_counter()
    img = render_image(scene, cfg)
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
        ms = frame_ms(scene, cfg)
        label = f"median CUDA-event frame time on {torch.cuda.get_device_name(scene.device)}"
    else:
        ms = (time.perf_counter() - t0) * 1e3
        label = "one render, host wall clock, cpu"
    print(f"frame {ms:.3f} ms ({label}); "
          f"{mrays_per_s(scene, ms):.2f} Mrays/s (primary+shadow)")
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
    pr = sub.add_parser("render", help="render a built-in scene to PNG")
    pr.add_argument("--builtin", choices=["mount", "spheres"], default="mount")
    pr.add_argument("--res", type=int, default=512)
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
