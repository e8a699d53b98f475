"""Timing on the card with CUDA events; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/utils/timing.py``.

Every call is timed between two CUDA events on the current stream, and the
result is the median after warm-up. Frames are distinct work: the pixel
grid drifts by 0.37 px per frame (the drift of ``bench.py``), so no frame
repeats another's inputs. Without a card these raise: a time here is a
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


def frame_ms(scene: Scene, cfg: RenderConfig, *, frames: int = 21,
             warmup: int = 3) -> float:
    """Median ms of a full-frame ``render_tile`` over ``frames`` frames."""
    from ..models.whitted import pixel_grid, render_tile

    if scene.device.type != "cuda":
        raise RuntimeError(f"frame timing needs a scene on a CUDA device, "
                           f"not {scene.device}")
    cam = scene.camera
    px, py = pixel_grid(cam.res_x, cam.res_y, scene.device)
    args = [(scene, px + 0.37 * i, py, cfg) for i in range(frames)]
    return cuda_ms(render_tile, args, warmup=warmup)


def mrays_per_s(scene: Scene, frame_time_ms: float) -> float:
    """Rate in the primary+shadow convention of ``bench.py``:
    res_x·res_y·(1 + n_lights) rays per frame."""
    cam = scene.camera
    rays = cam.res_x * cam.res_y * (1 + scene.n_lights)
    return rays / (frame_time_ms * 1e-3) / 1e6
