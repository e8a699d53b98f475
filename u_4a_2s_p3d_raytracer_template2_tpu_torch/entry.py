"""Entry points of the port: the counterpart of the repository's
``__graft_entry__.py``.

``entry(device="cuda")`` returns the forward render of the flagship scene
(mount_low at 64x64, the Whitted renderer) and example arguments for it.
``dryrun_multichip(n, device="cuda")`` starts n ranks (``parallel/launch``)
and runs the sharded forward render, one sharded ``train_step`` and one
``train_step_full`` of mount_low, and a sharded path-traced frame, all at
16x16, checking that every rank holds the same finite results. On CUDA
the ranks run over NCCL when every rank has a card of its own, rank r on
``cuda:r``, and over gloo on the card ``device`` names when there are more
ranks than cards (NCCL refuses two ranks on one device;
``parallel/dist.rank_device``); on the CPU the ranks use gloo.

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.entry [--device cpu] [--ranks 2]
"""
from __future__ import annotations

import argparse
import math

import torch

RES = 16


def entry(device="cuda"):
    """(forward, example_args): ``forward(scene, px, py, generator)`` is
    ``models/whitted.render_tile`` of mount_low at 64x64 under the default
    config, [4096, 3]; the example args are the scene on ``device`` and
    the frame's pixel indices."""
    from .core.build import build_scene
    from .core.types import RenderConfig
    from .models.scenes import mount_scene
    from .models.whitted import pixel_grid, render_tile

    dev = torch.device(device)
    scene = build_scene(mount_scene(res=64), device=dev)
    cfg = RenderConfig()

    def forward(scene, px, py, generator):
        return render_tile(scene, px, py, cfg, generator)

    px, py = pixel_grid(64, 64, dev)
    return forward, (scene, px, py,
                     torch.Generator(device=dev).manual_seed(0))


def _rank_device(device: str, backend: str) -> torch.device:
    from .parallel.dist import rank_device

    dev = rank_device(device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _dryrun_rank(rank: int, size: int, device: str, backend: str) -> dict:
    """One rank of ``dryrun_multichip``: the readings every rank must
    share."""
    from .core.build import build_scene
    from .core.types import RenderConfig
    from .models.glsl_scene import glsl_camera, glsl_world
    from .models.pathtracer import PTConfig
    from .models.scenes import mount_scene
    from .parallel import dist

    dev = _rank_device(device, backend)
    scene = build_scene(mount_scene(res=RES), device=dev)
    cfg = RenderConfig()
    img = dist.render_image_sharded(scene, cfg)
    new, loss = dist.train_step(scene, img * 0.9, cfg, 0.1)
    new_full, loss_full = dist.train_step_full(
        scene, img * 0.9, cfg, 0.01, None,
        dist.lr_scales(materials=1.0, light_pos=1.0, light_color=1.0,
                       camera=1.0))
    world = glsl_world(device=dev)
    frame = dist.pt_frame_sharded(world, glsl_camera(RES, RES, device=dev),
                                  PTConfig(max_bounces=3))
    return {"image": img.cpu(), "loss": float(loss),
            "loss_full": float(loss_full),
            "diff_color": new.materials.diff_color.cpu(),
            "light_pos": new_full.lights.position.cpu(),
            "frame": frame.cpu()}


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """The sharded render, train steps and path-traced frame on n ranks
    (see the module docstring); raises unless every rank returns the same
    finite images and losses. Returns rank 0's readings."""
    from .parallel import launch

    on_cuda = torch.device(device).type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available")
    backend = ("nccl" if on_cuda and n <= torch.cuda.device_count()
               else "gloo")
    results = launch.run(_dryrun_rank, n, device, backend, backend=backend)
    first = results[0]
    for key, value in first.items():
        if isinstance(value, float):
            ok = math.isfinite(value) and value >= 0.0
        else:
            ok = bool(torch.isfinite(value).all())
        if not ok:
            raise AssertionError(f"dryrun_multichip: {key} is not finite")
        if any((r[key] != value) if isinstance(value, float)
               else not torch.equal(r[key], value) for r in results[1:]):
            raise AssertionError(f"dryrun_multichip: the ranks' {key} "
                                 "differ")
    if first["image"].shape != (RES, RES, 3):
        raise AssertionError(f"bad image shape {first['image'].shape}")
    return first


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="u_4a_2s_p3d_raytracer_template2_tpu_torch.entry")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=2)
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print(f"entry() forward: {tuple(out.shape)} on {out.device}")
    got = dryrun_multichip(args.ranks, args.device)
    print(f"dryrun_multichip({args.ranks}) on {args.device}: loss "
          f"{got['loss']:.6f}, full loss {got['loss_full']:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
