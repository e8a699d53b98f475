"""Compacted wavefront Whitted tracer: the level sweep without dead slots;
the counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/models/
whitted_wavefront.py`` (``trace_rays_wavefront``, lines 46-180 there).

The sweep (models/whitted.trace_rays) holds ``R·2^l`` slots at level
``l``, most of them dead. The Whitted combine ``color = local +
KR·specColor·refl + (1-KR)·refr`` (main.cpp:719) is linear, so each queue
entry here carries a throughput weight (the product of the fold
coefficients on its path) and adds ``weight · local`` straight into its
pixel. A hit spawns its children with weights ``w·KR·specColor`` and
``w·(1-KR)``; a child whose weight is zero is not queued. (The JAX
module drops a child whose weight has no positive component, and so loses
the negative-weight children the sweep folds in: Schlick's KR is negative
on some refractive hits in the reference's refraction mode, -0.0027 at
pixel (11, 13) of mount_low at 24x24, depth 4. Here they are queued, so
the engine equals the sweep.) The depth-cap
clamp (main.cpp:632-634) applies on the last round, as in the sweep, so
the two differ only in the order of f32 additions.

Between rounds the children (reflection and refraction interleaved, as
the sweep lays them out) are compacted into a queue of
``ceil(R · cfg.wavefront_capacity)`` entries by a device ``cumsum``, a
binary search of it and one gather; children beyond capacity are dropped. The live count stays a
device tensor: the host never reads it, so a round issues no sync; one
device op a round adds it to the queue's counter (``live_counter``), which
benchmarks and checks read after the frame. The
queue's dead entries form a suffix and reach the walk and brute force as
``dead = ~active``: the walk packs the live slots inside its own launch,
brute force on the device, without the host knowing the count.

Each entry carries its pixel and its tree path (int64, PyTorch's index
type) and reads its draws of the sample plan by them
(models/samples.NodeDraws), so the wavefront reads the same plan as the
sweep and the CUDA Whitted kernel and equals the sweep draw for draw, in
distribution mode too.

The JAX module's TPU workarounds have no counterpart: its pixel ids ride
in the f32 payload, its payload is one [*, 12] block for one scatter, its
empty lanes start at a far origin (1e8) so that its packet walk leaves
them at the root, and ``wavefront_defer_sky`` defers the sky lookups to an
epilogue for XLA's scheduler. Here the dead entries are not traced at all
and keep finite defaults (origin 0, direction +z, weight 0, a pixel each),
and
``wavefront_defer_sky`` is accepted and gives the same image through the
per-level lookups.
"""
from __future__ import annotations

import math

import torch

from ..core.types import RenderConfig, Rays, Scene, filled
from . import whitted
from .samples import NodeDraws

# rounds the queue's counter holds (live_counter)
LEVELS = 32
# the queue's counter of each device (live_counter)
_LIVE = {}

# float payload of an entry: origin (3), direction (3), time, ior, weight
# (3); its defaults on a dead entry
_DEFAULT = (0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0)


def _interleave(a, b):
    return torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:]))


def _payload(rays: Rays, ior, w):
    return torch.cat([rays.origin, rays.direction, rays.time[:, None],
                      ior[:, None], w], dim=-1)


def live_counter(device) -> torch.Tensor:
    """The queue's counter on ``device``: int64 [LEVELS], entry ``l`` the
    live entries of round ``l`` (clamped to the queue's capacity) summed
    over every trace on the device since the process began. Round 0 (the
    primary rays, all live) and rounds from ``LEVELS`` on are not counted.
    A round adds its count with one device op, inside a captured frame
    too, so a replay counts as the eager trace does; the program never
    reads the counter (a reader takes the difference of two copies). It
    is made at the device's first trace, which runs eagerly: a compiled
    frame is warmed up before it is captured (utils/graphs.py)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    live = _LIVE.get(device)
    if live is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the wavefront queue's counter is made while a capture is "
                "open: trace once eagerly first")
        live = _LIVE[device] = torch.zeros(LEVELS, dtype=torch.int64,
                                           device=device)
    return live


def trace_rays_wavefront(scene: Scene, rays: Rays, cfg: RenderConfig,
                         rows: torch.Tensor | None = None,
                         offsets=None) -> torch.Tensor:
    """Color for a batch of primary rays through the compacted wavefront.
    [R,3], unclamped as ``whitted.trace_rays``'s; ``rows``/``offsets`` as
    there."""
    whitted.check_config(cfg)
    R = rays.origin.shape[0]
    layout, rows = whitted.trace_values(scene, cfg, R, rows, offsets)
    dev = rays.origin.device
    spawn_refl = scene.has_reflective
    spawn_refr = scene.has_transmissive
    q_active = torch.ones(R, dtype=torch.bool, device=dev)
    q_ior = torch.ones(R, dtype=rays.origin.dtype, device=dev)
    q_pix = torch.arange(R, device=dev)
    q_path = torch.zeros(R, dtype=torch.int64, device=dev)

    if not (spawn_refl or spawn_refr) or cfg.max_depth <= 1:
        local, _ = whitted._level_step(
            scene, rays, q_active, q_ior, cfg, True,
            NodeDraws(layout, 0, rows, q_pix, q_path))
        return local

    cap = int(math.ceil(R * cfg.wavefront_capacity))
    slots = torch.arange(cap, device=dev)
    live = live_counter(dev)
    # a dead entry's (pixel, path): path 0 of a pixel of its own where it
    # can, so that the zeros it adds do not pile onto one pixel of the
    # accumulation
    spread = torch.stack([slots % R, torch.zeros_like(slots)], dim=-1)
    default = filled(_DEFAULT, rays.origin.dtype, dev)
    out = torch.zeros((R, 3), dtype=rays.origin.dtype, device=dev)
    q_rays = rays
    q_w = torch.ones((R, 3), dtype=rays.origin.dtype, device=dev)
    for lvl in range(cfg.max_depth):
        spawn = lvl < cfg.max_depth - 1
        color, nxt = whitted._level_step(
            scene, q_rays, q_active, q_ior, cfg, spawn,
            NodeDraws(layout, lvl, rows, q_pix, q_path))
        # local on a hit, the background on a miss, 0 on a dead entry
        # (whose weight is 0 too); a pixel's entries add in queue order (a
        # deterministic, sorted accumulation on CUDA too)
        out.index_put_((q_pix,), q_w * color, accumulate=True)
        if not spawn:
            break

        children, fold = nxt
        kr = fold["kr"][:, None]
        refl_rays, refl_act, refl_ior = children["refl"]
        refr_rays, refr_act, refr_ior = children["refr"]
        refl_w = q_w * kr * fold["spec_color"]
        refr_w = q_w * (1.0 - kr)
        # zero-throughput children contribute exactly nothing: not queued
        # (a negative weight, from a negative Schlick KR, is queued)
        refl_act = refl_act & (refl_w != 0.0).any(dim=-1)
        refr_act = refr_act & (refr_w != 0.0).any(dim=-1)
        refl = _payload(refl_rays, refl_ior, refl_w)
        refr = _payload(refr_rays, refr_ior, refr_w)
        if spawn_refl and spawn_refr:
            c_f = _interleave(refl, refr)
            c_act = _interleave(refl_act, refr_act)
            c_i = torch.stack([_interleave(q_pix, q_pix),
                               _interleave(2 * q_path, 2 * q_path + 1)],
                              dim=-1)
        else:
            c_f, c_act = (refl, refl_act) if spawn_refl else (refr, refr_act)
            c_i = torch.stack([q_pix, q_path], dim=-1)

        # stream compaction: entry j takes the (j+1)-th live child, found
        # by a binary search of the children's running count (a gather
        # where a scatter would send every dead child to one trash row);
        # children past the first ``cap`` are dropped
        count = torch.cumsum(c_act, dim=0)
        n_live = count[-1]
        q_active = slots < n_live
        src = torch.searchsorted(count, slots + 1).clamp(
            max=c_act.shape[0] - 1)
        # index_select: the dead entries all read the last child, and the
        # backward of [src] would add their zeros into it in one serial
        # loop on CUDA (ops/intersect.gather_prims)
        q_f = torch.where(q_active[:, None], c_f.index_select(0, src),
                          default)
        q_i = torch.where(q_active[:, None], c_i[src], spread)
        q_rays = Rays(q_f[:, 0:3], q_f[:, 3:6], q_f[:, 6])
        q_ior, q_w = q_f[:, 7], q_f[:, 8:11]
        q_pix, q_path = q_i[:, 0], q_i[:, 1]
        if lvl + 1 < LEVELS:
            # the live entries of the next round: n_live, which passes cap
            # only where the children outnumber the queue
            live[lvl + 1].add_(n_live if c_act.shape[0] <= cap
                               else n_live.clamp(max=cap))
    return out
