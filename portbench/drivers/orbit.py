"""The orbit viewer: a closed loop of one viewer whose eye steps round the
scene, one frame in flight (traffic kind ``orbit``).

Each frame is what the reference's viewer and ``cli orbit`` do a frame:
the camera moved to the next eye of the orbit (the program's
``ops/camera.with_eye``), one ``models/whitted.render_image`` call of the
compiled frame, and the image as 8-bit RGB on the host (x·255.99
saturated, the reference's u8fromfloat, on the card, then copied). A
frame's latency runs from its issue to its 8-bit image on the host.

The orbit turns about the scene's up axis through the point the camera
looks at, at the camera's distance, ``pitch_deg`` above the horizontal
(null: the camera's own elevation), ``step_deg`` a frame, so a turn has
360 / step_deg eyes; the seed picks the eye the window starts at, so every
seed renders the same eyes in another order. Set-up renders
``warmup_frames`` frames (the capture among them), then frames for
``warmup_s`` seconds more: a new process's frames run slower for about
its first ten seconds. The traffic file gives the
orbit, the warm-up, the frames sampled for the check and traced, and the
comparison's limit.

The comparison: a sample of the window's frames, drawn from the seed
(reservoir sampling over all of them), each held to the plain reference's
frame at the same eye, both in 8 bits: the number compared is the worst
sampled frame's share of pixels with a channel more than one level off.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import random
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import scenes, trace, work
from ..harness import Outcome, Window, device_record, sync
from ..reference import whitted as ref

CHECK = "bad_px"


def program():
    """The program's entry points this driver calls."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io import p3f
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        render_image,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import with_eye
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    return SimpleNamespace(build_scene=build_scene, RenderConfig=RenderConfig,
                           p3f=p3f, render_image=render_image,
                           with_eye=with_eye, graphs=graphs)


def eyes_of(desc: scenes.Description, traffic: dict) -> np.ndarray:
    """[n, 3] f32: the orbit's eyes, one a frame of a whole turn."""
    cam = desc.camera
    at = np.asarray(cam["at"], np.float64)
    rel = np.asarray(cam["eye"], np.float64) - at
    up = np.asarray(cam["up"], np.float64)
    up = up / np.linalg.norm(up)
    flat = rel - up * float(rel @ up)
    e1 = flat / np.linalg.norm(flat)
    e2 = np.cross(up, e1)
    r = float(np.linalg.norm(rel))
    b = (math.asin(float(rel @ up) / r) if traffic["pitch_deg"] is None
         else math.radians(traffic["pitch_deg"]))
    n = int(round(360.0 / traffic["step_deg"]))
    out = []
    for k in range(n):
        a = math.radians(k * traffic["step_deg"])
        out.append(at + r * (math.cos(b) * (math.cos(a) * e1
                                            + math.sin(a) * e2)
                             + math.sin(b) * up))
    return np.asarray(out, np.float32)


def _u8_host(img: torch.Tensor) -> torch.Tensor:
    """The frame as the viewer shows it: 8-bit RGB in host memory."""
    return img.mul(255.99).clamp_(0.0, 255.0).to(torch.uint8).cpu()


class Viewer:
    """The program side: the scene built once, then frames."""

    def __init__(self, cell, device, wrap=None):
        self.p = program()
        if wrap is not None:
            wrap(self.p)
        self.device = device
        self.desc = scenes.describe(cell.config)
        sd = scenes.to_scene_def(self.desc, self.p.p3f, cell.config["accel"])
        self.scene = self.p.build_scene(sd, device=device)
        self.cfg = self.p.RenderConfig(
            max_depth=int(cell.config["max_depth"]),
            engine=cell.config["engine"]).with_scene_flags(self.scene)
        self.eyes = torch.from_numpy(eyes_of(self.desc, cell.traffic)).to(
            device)

    def frame(self, k: int, spans: bool = False):
        """(8-bit image, host seconds inside render_image) of eye k; with
        ``spans``, each part inside a profiler range."""
        with trace.span("camera", spans):
            s = dataclasses.replace(self.scene, camera=self.p.with_eye(
                self.scene.camera, self.eyes[k % self.eyes.shape[0]]))
        with trace.span("render_image", spans):
            t0 = time.perf_counter()
            img = self.p.render_image(s, self.cfg)
            t1 = time.perf_counter()
        with trace.span("image_to_host", spans):
            return _u8_host(img), t1 - t0

    def release(self):
        self.p.graphs.CACHE.clear()
        self.scene = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _window(viewer: Viewer, k0: int, seconds: float, sample: int, rng):
    """Frames from eye k0 for ``seconds``: latencies, host spans, and a
    reservoir sample of (frame, eye, 8-bit image)."""
    lat, host, kept = [], [], []
    i = 0
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        u8, h = viewer.frame(k0 + i)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        host.append(h)
        if len(kept) < sample:
            kept.append((i, k0 + i, u8))
        else:
            j = rng.randrange(i + 1)
            if j < sample:
                kept[j] = (i, k0 + i, u8)
        i += 1
        if t1 - w0 >= seconds:
            return lat, host, kept, t1 - w0


def bad_px(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of pixels with a channel more than one 8-bit level off."""
    diff = (got.int() - want.int()).abs()
    return float((diff > 1).any(dim=-1).float().mean())


def _reference_frames(desc, eyes, ks, depth, device, dtype=torch.float32):
    rs = ref.build(desc, device, dtype)
    for k in ks:
        yield ref.to_u8(ref.render(ref.with_eye(
            rs, eyes[k % eyes.shape[0]]), depth)).cpu()


def _check(desc, eyes, kept, depth, device):
    """The worst ``bad_px`` of the sampled frames ``kept``."""
    want = _reference_frames(desc, eyes, [k for _, k, _ in kept], depth,
                             device)
    return max((bad_px(got, w) for (_, _, got), w in zip(kept, want)),
               default=0.0)


def _work_of(desc, eyes, ks, depth, device):
    """Bounds (ms) of the traced frames: walk and brute force."""
    rs = ref.build(desc, device)
    n_tri, n_sph = rs.tri.shape[0], rs.sph.shape[0]
    slots = rs.camera["res_x"] * rs.camera["res_y"]
    total = {"walk": 0.0, "brute": 0.0}
    for k in ks:
        stats = {}
        ref.render(ref.with_eye(rs, eyes[k % eyes.shape[0]]), depth, stats)
        q = stats["queries"]
        total["walk"] += work.walk_work(q, slots, n_sph, n_tri)
        total["brute"] += work.brute_work(q, slots, n_sph, n_tri)
    return total


def run(cell, args, t0: float, wrap=None) -> Outcome:
    device = torch.device(args.device)
    traffic = cell.traffic
    viewer = Viewer(cell, device, wrap)
    n = viewer.eyes.shape[0]
    k0 = args.seed % n
    warm = int(traffic["warmup_frames"])
    for w in range(warm):
        viewer.frame(k0 - 1 - w)
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < float(traffic["warmup_s"]):
        warm += 1
        viewer.frame(k0 - warm)
    sync(device)
    setup_s = time.perf_counter() - t0
    rng = random.Random(f"{args.seed}:sample")
    lat, host, kept, wall = _window(viewer, k0, args.seconds,
                                    int(traffic["sample_frames"]), rng)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tr, traced_ks = None, []
    if args.trace:
        start = k0 + len(lat)
        units = int(traffic["trace_frames"])
        traced_ks = [start + i for i in range(units)]
        viewer.frame(start - 1)  # the profiler's own start-up, untraced
        sync(device)
        tr = trace.traced(lambda: [viewer.frame(k, True) for k in traced_ks],
                          units, device)
    dev = device_record(device, cell.chips, peak, tr)
    desc, eyes, depth = viewer.desc, viewer.eyes, viewer.cfg.max_depth
    viewer.release()
    c0 = time.perf_counter()
    worst = _check(desc, eyes, kept, depth, device)
    print(f"portbench: reference check of {len(kept)} frames "
          f"{time.perf_counter() - c0:.1f} s", file=sys.stderr)
    works = {}

    def work_of(kind):
        if not traced_ks:
            return None
        if not works:
            works.update(_work_of(desc, eyes, traced_ks, depth, device))
        return works.get(kind)

    window = Window("frame", len(lat), wall, lat, host, setup_s, int(peak))
    return Outcome(window, cell.config, traffic,
                   {CHECK: (worst, float(traffic["limits"][CHECK]))},
                   attempted=len(lat), failed=0, device=dev, trace=tr,
                   work=work_of)


def calibrate(cell, args, seeds, wrap=None):
    """The comparison's reading on each seed (a window of ``--seconds``
    from the seed's start eye), and with ``args.control`` the control's:
    the reference computed in bfloat16 in the program's place."""
    device = torch.device(args.device)
    traffic = cell.traffic
    viewer = Viewer(cell, device, wrap)
    n = viewer.eyes.shape[0]
    for w in range(int(traffic["warmup_frames"])):
        viewer.frame(w)
    kept_by_seed = {}
    for seed in seeds:
        rng = random.Random(f"{seed}:sample")
        lat, _, kept, wall = _window(viewer, seed % n, args.seconds,
                                     int(traffic["sample_frames"]), rng)
        kept_by_seed[seed] = (kept, len(lat), wall)
    desc, eyes, depth = viewer.desc, viewer.eyes, viewer.cfg.max_depth
    viewer.release()
    for seed in seeds:
        kept, frames, wall = kept_by_seed[seed]
        ks = [k for _, k, _ in kept]
        want = list(_reference_frames(desc, eyes, ks, depth, device))
        line = {"seed": seed, "frames": frames,
                "frame_ms": 1e3 * wall / frames,
                CHECK: max(bad_px(g, w) for (_, _, g), w in zip(kept, want))}
        if args.control:
            got = _reference_frames(desc, eyes, ks, depth, device,
                                    torch.bfloat16)
            line["control_" + CHECK] = max(bad_px(g, w)
                                           for g, w in zip(got, want))
        yield line
