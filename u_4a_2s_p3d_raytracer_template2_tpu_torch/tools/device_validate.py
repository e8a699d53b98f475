"""T2 on the card: the f32 FMA ceiling that a plain stream reaches, and the
per-class instruction ceilings; the counterpart of the ``vpu_peak`` section
and the roofline convention of tools/device_validate.py. Its
"distribution" section is the JAX tool's (tools/device_validate.py:357-413
there): a distribution-mode frame (spp 4, so 16 AA+DoF samples a pixel)
with a 6x2048x2048 u8 skybox on the megakernel engine.

Its "grid" section is the JAX tool's (tools/device_validate.py:554-600
there): the per-ray grid DDA (accel/traverse.py: the kernel of
csrc/perray_traverse.cu on the card, its plain version off it) against
the BVH walk's kernel on a grid scene's primary rays, with both times, the
hit ids' agreement and the two images' agreement. mount_high.p3f is not in
the repo, so the scene is the 7,396-sphere field
(``sphere_field_scene(n_side=86)``) built with ``ACCEL_GRID``; mount_high
waits for its file.

The JAX tool's other sections are not repeated here: chip_smoke.py's phases
3-14 hold every ported kernel (spheres K4, the Whitted megakernel K1/K2,
the path tracer K3, the packet walk K5) to its plain version beside its
bound. Its dragon, mount_high and balls_low rows wait for their .p3f files.

Bounds keep the datasheet peaks (chip_smoke.PEAK_F32_FLOPS, 67 TFLOP/s at
700 W); what T2 measures stands beside them as what a plain FMA stream
reaches at the clock the card holds.

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.device_validate \\
        [peak|sass|distribution|grid|all] [--p3f scene.p3f] [--device cpu]
"""
from __future__ import annotations

import argparse
import re
import subprocess
from collections import Counter

import torch

ROWS, LANE, N_FMA = 256, 128, 512     # the JAX tool's block and chain
# blocks a launch: the JAX tool's 64, grown 32x so that one launch runs
# about a millisecond on an H100 (2^26 elements, 68.7 GFLOP)
GRID = 2048
FLOP_PER_ELEMENT = 2 * N_FMA
DATASHEET_TFLOPS = 67.0   # H100 SXM f32 outside the tensor cores, 700 W
# kernel against plain version, largest |got - want| / max(|want|, 1): fmaf
# rounds once where the plain version rounds the product and the sum; a
# NumPy emulation of the JAX tool's 2,097,152 elements reads 2.8e-6
RTOL = 3e-5

# Instructions per clock per SM, compute capability 9.0, from the CUDA C++
# Programming Guide's table "Throughput of Native Arithmetic Instructions":
# "32-bit floating-point add, multiply, multiply-add" 128; "32-bit
# floating-point reciprocal, reciprocal square root, base-2 logarithm,
# base 2 exponential, sine, cosine" 16 (the MUFU unit). A class's ceiling is
# the rate of the one instruction its step cannot do without: an FFMA
# (fma), an FADD with an abs modifier (cheap), the MUFU reciprocal of IEEE
# division (div), MUFU.RSQ (rsqrt), the add or subtract a select picks
# (select). A measured rate above it means a folded chain or a wrong count.
PER_SM_PER_CLOCK = {"fma": 128, "cheap": 128, "div": 16, "rsqrt": 16,
                    "select": 128}


def card_info() -> dict:
    """nvidia-smi's name, power limit, SM clock and maximum SM clock of
    card 0."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power, sm, max_sm = (f.strip() for f in line.split(","))
    return {"name": name, "power_limit": power, "clocks_sm": sm,
            "clocks_max_sm": max_sm,
            "max_sm_hz": float(re.match(r"[\d.]+", max_sm).group()) * 1e6}


def class_ceiling(op: str, device=None) -> float:
    """Chain steps/s of the class ``op`` if every SM retired its limiting
    instruction (PER_SM_PER_CLOCK) at the maximum SM clock."""
    sms = torch.cuda.get_device_properties(
        torch.device(device or "cuda")).multi_processor_count
    return PER_SM_PER_CLOCK[op] * sms * card_info()["max_sm_hz"]


def fma_peak_input(grid: int, device) -> torch.Tensor:
    """The JAX tool's input: linspace(0.9, 1.1) over [grid·256, 128]."""
    return torch.linspace(0.9, 1.1, grid * ROWS * LANE, dtype=torch.float32,
                          device=device).reshape(grid * ROWS, LANE)


def fma_peak_plain(x) -> torch.Tensor:
    """The plain version of ``kernels.fma_peak``: tools/device_validate.py
    :120-135 one PyTorch op at a time."""
    a = x
    b = a * 1.0000001 + 0.3
    c = a * 0.9999999 - 0.2
    d = a + 0.1
    e = a - 0.1
    for _ in range(N_FMA // 8):
        b = b * a + 0.25
        c = c * a - 0.25
        d = d * a + 0.5
        e = e * a - 0.5
        b = b * 1.0000001 + c
        c = c * 0.9999998 + d
        d = d * 1.0000002 + e
        e = e * 0.9999997 + b
    return b + c + d + e


def clock_under_load(fn, args, ms: float, seconds: float = 0.5) -> dict:
    """card_info() read while about ``seconds`` of ``fn(*args)`` calls (each
    about ``ms``) are queued on the card."""
    for _ in range(max(1, int(seconds * 1e3 / ms))):
        fn(*args)
    info = card_info()
    torch.cuda.synchronize()
    return info


def vpu_peak(device="cuda", grid: int = GRID) -> dict:
    """T2 on the card: {tflops, ms, plain_ms, err (rel_err), abs_err, share
    (of the datasheet's 67 TFLOP/s), ceiling (TFLOP/s at the maximum SM
    clock), and the card's name, power limit and SM clock read under
    load}. Raises if the kernel
    and its plain version differ beyond RTOL or the rate is over 1.05 times
    the FMA ceiling."""
    from .. import kernels
    from ..utils.timing import cuda_ms, queued_ms
    from .roofline_mount import rel_err

    x = fma_peak_input(grid, device)
    got, want = kernels.fma_peak(x), fma_peak_plain(x)
    err = rel_err(got, want)
    abs_err = float((got.double() - want.double()).abs().max())
    del got, want
    ms = queued_ms(kernels.fma_peak, [(x,)] * 3)
    plain_ms = cuda_ms(fma_peak_plain, [(x,)], warmup=1)
    flop = x.numel() * FLOP_PER_ELEMENT
    tflops = flop / (ms * 1e-3) / 1e12
    ceiling = 2 * class_ceiling("fma", device) / 1e12
    info = clock_under_load(kernels.fma_peak, (x,), ms)
    out = dict(tflops=tflops, ms=ms, plain_ms=plain_ms, err=err,
               abs_err=abs_err, share=tflops / DATASHEET_TFLOPS,
               ceiling=ceiling, flop=flop, **info)
    print(f"vpu_peak: {tflops:.3f} TFLOP/s f32 FMA "
          f"({100 * out['share']:.1f}% of {DATASHEET_TFLOPS:g}, "
          f"{100 * tflops / ceiling:.1f}% of {ceiling:.2f} at the "
          f"maximum SM clock); {ms:.4f} ms a launch of {x.numel()} elements; "
          f"plain {plain_ms:.3f} ms; err {err:.3g} (limit {RTOL}); "
          f"{info['name']}, {info['power_limit']}, SM clock "
          f"{info['clocks_sm']} under load (max {info['clocks_max_sm']})",
          flush=True)
    if not err <= RTOL:
        raise AssertionError(f"T2: kernel and plain version differ by "
                             f"{err:.3g} (limit {RTOL})")
    if tflops > 1.05 * ceiling:
        raise AssertionError(f"T2: {tflops:.4g} TFLOP/s is over 1.05 x the "
                             f"FMA ceiling {ceiling:.4g}")
    return out


def sass_counts() -> dict[str, Counter]:
    """Opcodes of each probe kernel in the built library (cuobjdump -sass
    of csrc/probes.cu), by kernel: the check that no chain was folded."""
    from ..kernels import build as kb

    cuobjdump = kb.nvcc().replace("nvcc", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(kb.build("probes"))],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name:
            out[name][m.group(1)] += 1
    return out


def distribution_scene(device, p3f=None, env_dir=None, res: int = 512,
                       sky_side: int = 2048):
    """(scene, cfg) of the distribution section: the ``.p3f`` file ``p3f``
    (its spp and env lines), or, since balls_low.p3f is not in the repo,
    mount_low at ``res``² in distribution mode
    (``scenes.mount_distribution_scene``: spp 4, a lens of 8 pixels) with
    ``sky_side``² u8 faces made from seed 0 and written as PNGs into
    ``env_dir`` (unless its faces are there). The
    config: the megakernel engine, jittered soft shadows, fuzzy reflection
    and the skybox, with the scene's spp coupling."""
    import os

    from ..core.build import build_scene
    from ..core.types import RenderConfig
    from ..io.p3f import parse_p3f
    from ..io.skybox import save_skybox_dir
    from ..models import scenes

    if p3f is not None:
        sd = parse_p3f(p3f)
    else:
        if not os.path.exists(os.path.join(env_dir, "right.png")):
            save_skybox_dir(env_dir, scenes.synthetic_skybox(sky_side, 0))
        sd = scenes.mount_distribution_scene(res, env_dir)
    scene = build_scene(sd, device=device)
    cfg = RenderConfig(engine="megakernel", soft_shadow=True,
                       fuzzy_reflection=True,
                       use_skybox=True).with_scene_flags(scene)
    return scene, cfg


def distribution(device="cuda", p3f=None, env_dir=None, sub: int = 64
                 ) -> dict:
    """The distribution section: frame ms (median of 21 frames, draws
    included), Mrays/s as res²·spp²·(1 + lights), the image's mean and
    std, and the kernel against its plain version on the frame's lower-left
    ``sub``² pixels from the same draws."""
    import dataclasses
    import tempfile

    from ..models.whitted import pixel_grid, render_image, render_tile
    from ..models.samples import draw_plan, scene_layout
    from ..utils.timing import frame_ms, mrays_per_s

    tmp = None
    if p3f is None and env_dir is None:
        tmp = tempfile.TemporaryDirectory()
        env_dir = tmp.name
    scene, cfg = distribution_scene(device, p3f, env_dir)
    img = render_image(scene, cfg,
                       torch.Generator(device=device).manual_seed(0))
    ms = frame_ms(scene, cfg)
    cam = scene.camera
    px, py = pixel_grid(cam.res_x, cam.res_y, scene.device)
    keep = (px < sub) & (py < sub)
    px, py = px[keep], py[keep]
    draws = draw_plan(torch.Generator(device=device).manual_seed(1),
                      scene_layout(scene, cfg), cfg, px.shape[0])
    got = render_tile(scene, px, py, cfg, draws=draws)
    want = render_tile(scene, px, py, dataclasses.replace(cfg, engine="sweep"),
                       draws=draws)
    diff = (got.double() - want.double()).abs()
    out = dict(
        scene=p3f or f"mount_low {cam.res_x}x{cam.res_y}",
        samples_per_pixel=max(cfg.spp, 1) ** 2 if cfg.anti_aliasing else 1,
        skybox=(f"{tuple(scene.skybox.shape)} {scene.skybox.dtype}"
                if scene.has_skybox else "none"),
        frame_ms=ms, mrays_per_s=mrays_per_s(scene, ms, cfg),
        image_mean=float(img.mean()), image_std=float(img.std()),
        kernel_vs_plain=dict(pixels=px.shape[0], max=float(diff.max()),
                             mean=float(diff.mean())))
    info = card_info()
    out.update(card=info["name"], power_limit=info["power_limit"])
    print(f"distribution: {out}", flush=True)
    if tmp is not None:
        tmp.cleanup()
    return out


def grid(device="cuda", res: int = 256, n_side: int = 86) -> dict:
    """The grid section: the field of ``n_side``² spheres built with
    ACCEL_GRID at ``res``²; the closest hits of its primary rays through
    the grid DDA and through the walk (ms each, CUDA events, median of 3
    drifting frames; not measured off the card), the plain DDA's
    iterations and host syncs on one frame's rays (0 on the card, where
    the kernel of csrc/perray_traverse.cu runs and reads nothing back to
    the host), the share of equal hit ids, and the
    depth-4 images
    under ``accel_impl="perray"`` and the walk (pixels beyond 2e-3, max
    abs difference)."""
    from ..accel import traverse
    from ..accel.packets import packet_closest_hit
    from ..core import constants as C
    from ..core.build import build_scene
    from ..core.types import RenderConfig
    from ..models.scenes import sphere_field_scene
    from ..models.whitted import pixel_grid, render_image
    from ..ops.camera import pinhole_rays
    from ..utils.timing import cuda_ms

    scene = build_scene(sphere_field_scene(n_side=n_side, res=res),
                        device=device, accel=C.ACCEL_GRID)
    g = scene.grid
    px, py = pixel_grid(res, res, scene.device)
    rays = [pinhole_rays(scene.camera, px + 0.5 + 0.37 * i, py + 0.5)
            for i in range(3)]

    def dda(r):
        return traverse.grid_closest_hit(g, scene.prims, r)

    def walk(r):
        return packet_closest_hit(scene.packets, r)

    timed = scene.device.type == "cuda"  # else times are not measured
    before = dict(traverse.stats)
    t_g, id_g = dda(rays[0])
    iters = traverse.stats["iterations"] - before["iterations"]
    syncs = traverse.stats["syncs"] - before["syncs"]
    t_w, id_w = walk(rays[0])
    dda_ms = cuda_ms(dda, [(r,) for r in rays], warmup=1) if timed else None
    walk_ms = (cuda_ms(walk, [(r,) for r in rays], warmup=1) if timed
               else None)
    img_dda = render_image(scene, RenderConfig(accel_impl="perray"))
    img_walk = render_image(scene, RenderConfig())
    diff = (img_dda - img_walk).abs()
    out = dict(
        scene=f"field{n_side} ({scene.n_objects} objects) {res}x{res}, "
              f"grid {g.nx}x{g.ny}x{g.nz}, {g.max_per_cell} items a cell",
        grid_dda_ms=dda_ms, walk_ms=walk_ms,
        ratio=dda_ms / walk_ms if timed else None,
        dda_iterations=iters, dda_syncs=syncs,
        id_agree_frac=float((id_g == id_w).float().mean()),
        t_max_rel=float(((t_g - t_w).abs() / t_w.abs().clamp(min=1.0))
                        [id_g >= 0].max()),
        image_beyond_2e3=float((diff.amax(dim=-1) > 2e-3).float().mean()),
        image_max_abs=float(diff.max()))
    if timed:
        info = card_info()
        out.update(card=info["name"], power_limit=info["power_limit"])
    print(f"grid: {out}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("part", nargs="?", default="all",
                    choices=("peak", "sass", "distribution", "grid",
                             "all"))
    ap.add_argument("--p3f", default=None,
                    help="the distribution section's scene (default: "
                    "mount_low in distribution mode with a seeded skybox)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda":
        y = fma_peak_plain(fma_peak_input(1, device))
        print(f"plain version only (--device cpu), [{ROWS}, {LANE}]: finite "
              f"{bool(torch.isfinite(y).all())}, max {float(y.max()):.4g}; "
              "vpu_peak: not measured")
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "version only")
    if args.part in ("peak", "all"):
        vpu_peak(device)
    if args.part in ("sass", "all"):
        for name, counts in sass_counts().items():
            print(f"sass {name}: " + ", ".join(
                f"{op} {n}" for op, n in counts.most_common()))
    if args.part in ("distribution", "all"):
        distribution(device, args.p3f)
    if args.part in ("grid", "all"):
        grid(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
