"""Command-line entry point of the port: the ``render`` subcommand of
``u_4a_2s_p3d_raytracer_template2_tpu/cli.py``.

Usage::

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.cli render \\
        --builtin mount --res 512 --engine megakernel -o mount.png

Renders a built-in scene, writes the PNG, and prints the frame time and the
rate in Mrays/s (primary + shadow rays). On a CUDA device the time is the
median of CUDA-event frame times; on the CPU it is one host wall-clock
render, labelled as such.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch


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
    pr.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    pr.add_argument("-o", "--output", default="RT_Output.png")
    pr.set_defaults(fn=cmd_render)
    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
