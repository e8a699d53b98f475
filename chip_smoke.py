"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each raising on failure:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile csrc/whitted_megakernel.cu with nvcc; print the build
     time and ptxas's register and spill report;
  3. kernel against plain: the CUDA kernel against its plain PyTorch version
     on the same rays, at 64x64 depth 4 (mount_low under all 12 Fresnel x
     refraction x shadow combinations, a four-type scene with 2 lights, a
     66-primitive sphere field) and at the main path's 512x512;
  4. main path: render_image of mount_low at 512x512, depth 4,
     engine="megakernel", with the kernel's launch counter reset just before
     and read just after; the image against the plain sweep; the PNG; the
     CLI render command as a subprocess;
  5. timing: kernel and plain version alone, and whole frames of both
     engines, as medians of CUDA-event times.
The line before the last is a JSON object of the kernels; the last line is
the JSON device record.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ATOL = 2e-3       # per-pixel tolerance of the repo's image comparison
MAX_BAD = 0.01    # fraction of pixels allowed beyond ATOL (silhouette flips)
RES = 512


def bad_fraction(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(fraction of pixels whose worst channel differs by more than ATOL,
    max abs difference); the criterion of tests/conftest.assert_images_close."""
    diff = (got.double() - want.double()).abs().amax(dim=-1)
    return float((diff > ATOL).double().mean()), float(diff.max())


def four_type_scene(res):
    """Triangle, reflective and glass spheres, plane and box, two lights."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef

    sd = SceneDef()
    sd.set_camera(eye=[0.5, 1.5, 6], at=[0, 0.3, 0], up=[0, 1, 0], fov=40,
                  hither=0.01, res_x=res, res_y=res, aperture_ratio=0,
                  focal_ratio=1)
    diffuse = sd.add_material([0.7, 0.7, 0.2], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    mirror = sd.add_material([0.1, 0.1, 0.1], 0.2, [0.9, 0.9, 0.9], 0.8, 200,
                             0, 1)
    glass = sd.add_material([0, 0, 0], 0.0, [1, 1, 1], 0.1, 100, 1, 1.5)
    sd.add_plane_points([0, -0.5, 0], [1, -0.5, 0], [0, -0.5, -1], diffuse)
    sd.add_sphere([-1.2, 0.3, 0], 0.8, mirror)
    sd.add_sphere([1.0, 0.2, 1.0], 0.7, glass)
    sd.add_triangle([-0.5, -0.4, 2.0], [0.5, -0.4, 2.0], [0, 0.7, 1.8],
                    diffuse)
    sd.add_box([-0.4, -0.5, -1.5], [0.6, 0.5, -0.6], mirror)
    sd.add_light([4, 6, 4], [1, 1, 1])
    sd.add_light([-5, 3, 2], [0.5, 0.4, 0.4])
    sd.bg_color = np.array([0.3, 0.5, 0.9], np.float32)
    return sd


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.image import save_png
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.kernels import build as kb
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        whitted_megakernel as mk,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
        render_image,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        pinhole_rays,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.timing import (
        cuda_ms,
        frame_ms,
        mrays_per_s,
    )

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    lib = kb.build("whitted_megakernel")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in kb.build_log("whitted_megakernel").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel against plain on the same rays
    def rays_of(scene, drift=0.0):
        cam = scene.camera
        px, py = pixel_grid(cam.res_x, cam.res_y, dev)
        r = pinhole_rays(cam, px + 0.5 + drift, py + 0.5)
        return r.origin.contiguous(), r.direction.contiguous()

    def compare(label, scene, cfg):
        o, d = rays_of(scene)
        shape = mk.shape_of(scene)
        tbl, lt, bg = mk.scene_tables(scene)
        got = kernels.whitted_megakernel(tbl, lt, bg, o, d, shape, cfg)
        want = mk.trace_rays_plain(shape, tbl, lt, bg, o, d, cfg)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: kernel output is not finite")
        bad, err = bad_fraction(got, want)
        print(f"compare {label}: {bad * 100:.3f}% pixels beyond {ATOL}, "
              f"max abs err {err:.3g}")
        if bad > MAX_BAD:
            raise AssertionError(
                f"{label}: kernel and plain version disagree on "
                f"{bad * 100:.2f}% of pixels (limit {MAX_BAD * 100}%)")
        return bad

    worst = 0.0
    mount64 = build_scene(scenes.mount_scene(res=64), device=dev)
    for fresnel in ("schlick", "reference_schlick", "reference_exact"):
        for refraction in ("reference", "physical"):
            for unbounded in (False, True):
                cfg = RenderConfig(fresnel_mode=fresnel,
                                   refraction_mode=refraction,
                                   shadow_unbounded=unbounded)
                worst = max(worst, compare(
                    f"mount64 {fresnel}/{refraction}/unbounded={unbounded}",
                    mount64, cfg))
    worst = max(worst, compare(
        "four-type 64", build_scene(four_type_scene(64), device=dev),
        RenderConfig()))
    worst = max(worst, compare(
        "four-type 64 soft-shadow grid",
        build_scene(four_type_scene(64), device=dev),
        RenderConfig(soft_shadow=True)))
    worst = max(worst, compare(
        "sphere_field n_side=8 64",
        build_scene(scenes.sphere_field_scene(n_side=8, res=64,
                                              accel=C.ACCEL_NONE),
                    device=dev),
        RenderConfig()))
    print(f"worst pixel fraction at 64x64: {worst * 100:.3f}%")

    scene = build_scene(scenes.mount_scene(res=RES), device=dev)
    cfg_mk = RenderConfig(engine="megakernel")
    cfg_sw = RenderConfig(engine="sweep")
    shape = mk.shape_of(scene)
    tbl, lt, bg = mk.scene_tables(scene)
    o, d = rays_of(scene)
    got = kernels.whitted_megakernel(tbl, lt, bg, o, d, shape, cfg_mk)
    want = mk.trace_rays_plain(shape, tbl, lt, bg, o, d, cfg_mk)
    torch.cuda.synchronize()
    bad512, max_abs_err = bad_fraction(got, want)
    print(f"compare mount{RES} (main path shapes): {bad512 * 100:.3f}% "
          f"pixels beyond {ATOL}, max abs err {max_abs_err:.3g}")
    if bad512 > MAX_BAD:
        raise AssertionError(f"kernel and plain version disagree at {RES}^2")

    # 4. main path through the entry points a user calls
    kernels.whitted_megakernel.launches = 0
    img = render_image(scene, cfg_mk)
    torch.cuda.synchronize()
    launches = kernels.whitted_megakernel.launches
    print(f"main path: render_image mount_low {RES}x{RES} depth "
          f"{cfg_mk.max_depth} engine=megakernel, kernel launches {launches}")
    if launches < 1:
        raise AssertionError("the main path did not launch the kernel")
    if img.shape != (RES, RES, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad image: {tuple(img.shape)}")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("image outside [0, 1]")
    plain_img = render_image(scene, cfg_sw)
    bad, err = bad_fraction(img, plain_img)
    print(f"main path against the plain sweep: {bad * 100:.3f}% pixels "
          f"beyond {ATOL}, max abs err {err:.3g}")
    if bad > MAX_BAD:
        raise AssertionError("main path image disagrees with the sweep")
    (ROOT / "build").mkdir(exist_ok=True)
    save_png(str(ROOT / "build" / "mount_smoke.png"), img)
    subprocess.run(
        [sys.executable, "-m", "u_4a_2s_p3d_raytracer_template2_tpu_torch.cli",
         "render", "--builtin", "mount", "--res", str(RES), "--engine",
         "megakernel", "-o", "build/mount.png"], cwd=ROOT, check=True)

    # 5. timing: the kernel and its plain version alone on drifting rays,
    # then whole frames of both engines
    inputs = [(tbl, lt, bg, *rays_of(scene, 0.37 * i), shape, cfg_mk)
              for i in range(21)]
    kernel_ms = cuda_ms(kernels.whitted_megakernel, inputs)
    plain_ms = cuda_ms(mk.trace_rays_plain,
                       [(shape, tbl, lt, bg, a[3], a[4], cfg_mk)
                        for a in inputs])
    print(f"kernel alone: {kernel_ms:.4f} ms; plain version alone: "
          f"{plain_ms:.4f} ms (mount_low {RES}x{RES} depth 4, {card})")
    for label, cfg in (("megakernel", cfg_mk), ("sweep", cfg_sw)):
        ms = frame_ms(scene, cfg)
        print(f"frame {label}: {ms:.4f} ms, {mrays_per_s(scene, ms):.2f} "
              f"Mrays/s (primary+shadow), mount_low {RES}x{RES} depth 4, "
              f"{card}")

    print(json.dumps({"kernels": [{
        "name": "whitted_megakernel",
        "route": "cuda",
        "source": "u_4a_2s_p3d_raytracer_template2_tpu_torch/csrc/"
                  "whitted_megakernel.cu",
        "replaces": "u_4a_2s_p3d_raytracer_template2_tpu/models/"
                    "whitted_megakernel.py:685",
        "also_replaces": "u_4a_2s_p3d_raytracer_template2_tpu/models/"
                         "whitted_streamed.py:353",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
