"""Timing on the card with CUDA events; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/utils/timing.py``.

Every call is timed between two CUDA events on the current stream, and the
result is the median after warm-up. Frames are distinct work: a Whitted
frame's pixel grid drifts by 0.37 px per frame (the drift of ``bench.py``)
and, in distribution mode, draws its samples from a generator of its own
seed inside the timed frame; a path-tracer frame draws from a generator of
its own seed, so no frame repeats another's inputs. Without a card these raise: a time here is a
device measurement.
"""
from __future__ import annotations

import statistics

import torch

from ..core.types import RenderConfig, Scene


def cuda_ms(fn, args_list, *, warmup: int = 3) -> float:
    """Median ms of ``fn(*args)`` over ``args_list``, after ``warmup`` calls
    on its first entry."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs a CUDA device")
    times = []
    for i, args in enumerate([args_list[0]] * warmup + list(args_list)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, args_list, *, rounds: int = 5, hold_cycles: int = 10**8
              ) -> float:
    """Device ms per call of ``fn(*args)`` over ``args_list``, the median of
    ``rounds`` rounds. In each round the calls are queued behind a device
    sleep of ``hold_cycles`` clock cycles (about 50 ms), and the events
    around them start when the sleep ends, so the host's launch overhead
    never leaves the device waiting: the time of the kernels and their gaps
    alone. ``cuda_ms`` instead times each call from an idle device, host
    overhead included, which is most of a call that runs for tens of
    microseconds."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs a CUDA device")
    fn(*args_list[0])
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        for args in args_list:
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(args_list))
    return statistics.median(times)


def frame_ms(scene: Scene, cfg: RenderConfig, *, frames: int = 21,
             warmup: int = 3) -> float:
    """Median ms of a full-frame ``render_tile`` over ``frames`` frames,
    the sample draws of a distribution-mode frame included (each frame's
    generator is made before the timed calls)."""
    from ..models.whitted import pixel_grid, render_tile

    if scene.device.type != "cuda":
        raise RuntimeError(f"frame timing needs a scene on a CUDA device, "
                           f"not {scene.device}")
    cam = scene.camera
    px, py = pixel_grid(cam.res_x, cam.res_y, scene.device)
    args = [(scene, px + 0.37 * i, py, cfg,
             torch.Generator(device=scene.device).manual_seed(1000 + i))
            for i in range(frames)]
    return cuda_ms(render_tile, args, warmup=warmup)


def mrays_per_s(scene: Scene, frame_time_ms: float,
                cfg: RenderConfig | None = None) -> float:
    """Rate in the primary+shadow convention of ``bench.py`` and the JAX
    CLI: res_x·res_y·spp²·(1 + n_lights) rays per frame (spp² samples a
    pixel under anti-aliasing, else 1)."""
    cam = scene.camera
    spp2 = max(cfg.spp, 1) ** 2 if cfg is not None and cfg.anti_aliasing \
        else 1
    rays = cam.res_x * cam.res_y * spp2 * (1 + scene.n_lights)
    return rays / (frame_time_ms * 1e-3) / 1e6


def pt_frame_ms(frame_fn, *, device, frames: int = 21,
                warmup: int = 3) -> float:
    """Median ms of a path-tracer frame ``frame_fn(generator)`` (e.g.
    ``models.pt_megakernel.make_render_frame``) over ``frames`` frames, each
    drawing from a ``torch.Generator`` on ``device`` with a seed of its own;
    the generators are made before the timed calls."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"frame timing needs a CUDA device, not {device}")
    gens = [(torch.Generator(device=device).manual_seed(1000 + i),)
            for i in range(frames)]
    return cuda_ms(frame_fn, gens, warmup=warmup)


def mpaths_per_s(res_x: int, res_y: int, frame_time_ms: float) -> float:
    """Path-tracer rate: res_x·res_y paths (1 spp) per frame, as the JAX
    bench's Mpaths/s."""
    return res_x * res_y / (frame_time_ms * 1e-3) / 1e6
