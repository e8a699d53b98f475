"""The sample plan of a Whitted render: every random value the
distribution mode needs (main.cpp:757-798 and 593-660), drawn before the
trace.

A render draws nothing inside its trace. Each subpixel of the spp×spp
anti-aliasing grid (one subpixel without AA) gets ``Draws``:

  * ``jitter`` [R, 2], raw U[0,1): the subpixel offsets (AA);
  * ``time`` [R], raw U[0,1): the shutter time (motion blur);
  * ``lens`` [R, 2], raw U[0,1): the lens sample's two draws (DoF);
  * ``rows`` [n_rows, R], raw U[0,1): the draws of the trace, one row per
    (tree node, quantity) in the layout of the JAX package's
    ``_stream_layout`` and ``_draw_stream``
    (``models/whitted_megakernel.py:280-312, 724-780``): a light's two
    offset draws per node under AA soft shadows, three unit-sphere draws
    per spawning node under fuzzy reflection.

The raw draws come from an explicit ``torch.Generator`` on the scene's
device; pure transforms turn them into values: ``ops/camera.primary_rays``
the camera's, ``stream_rows`` the trace's (the values of ``_draw_stream``:
the jittered light offsets with the subpixel indices, the unit-sphere
points). The sweep (models/whitted.py) and the megakernel's plain version
apply ``stream_rows`` to the rows they are given; the CUDA kernel applies
the same transforms to the same rows in its threads, so all three agree
draw for draw. PyTorch cannot reproduce the JAX package's threefry keys, so
the tests derive the raw draws from the JAX key chain.

Node (lvl, path) follows the sweep's interleave: slot = ray·W_l + path, the
reflection child of path p is 2p and the refraction child 2p+1 when both
spawn, p when one does. ``NodeDraws`` hands one level's values to
``models/whitted._level_step``: in the sweep's slot order
(``StreamLayout.level_values``), or for the wavefront engine's queue
entries by their (pixel, path) (``StreamLayout.node_values``), so both
engines read the same plan draw for draw.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from ..core.types import RenderConfig
from ..ops.sampling import uniform, unit_sphere_from_uniforms


class TreeShape(NamedTuple):
    branch: int     # children a hit spawns: 2 (refl and refr), else 1
    n_levels: int   # levels of the Whitted tree that are traced


def tree_shape(has_refl: bool, has_refr: bool, max_depth: int) -> TreeShape:
    """The static recursion tree: a scene with neither reflective nor
    transmissive materials traces one level (models/whitted.trace_rays)."""
    has_sec = has_refl or has_refr
    return TreeShape(2 if (has_refl and has_refr) else 1,
                     max_depth if has_sec else 1)


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    """Row assignment of the trace's sample values (``_stream_layout``).

    ``rowmap`` keys: ("shadow", lvl, path, li) -> (row_jx, row_jy) under
    soft shadows with AA; ("fuzzy", lvl, path) -> (r0, r1, r2) under fuzzy
    reflection at a spawning node of a scene with reflective materials.
    Rows run node by node in (lvl, path) order, a node's shadow rows first:
    node (lvl, path) starts at ``level_base[lvl] + path * node_rows[lvl]``
    (csrc/whitted_megakernel.cu computes the same)."""

    n_rows: int
    rowmap: dict
    shape: TreeShape
    n_lights: int
    soft_jit: bool
    fuzzy: bool
    level_base: tuple
    node_rows: tuple

    def level_values(self, rows: torch.Tensor, lvl: int,
                     offset: int) -> torch.Tensor:
        """[R·W] values of row ``offset`` of every node of level ``lvl``, in
        the sweep's slot order (slot = ray·W + path)."""
        W = self.shape.branch ** lvl
        start = self.level_base[lvl] + offset
        step = self.node_rows[lvl]
        return rows[start:start + W * step:step].t().reshape(-1)

    def node_values(self, rows: torch.Tensor, lvl: int, offset: int,
                    pixel: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
        """[n] values of row ``offset`` of the nodes (lvl, ``path``) [n] of
        the rays ``pixel`` [n]: row ``level_base[lvl] + path·node_rows[lvl]
        + offset``, column ``pixel``."""
        row = path * self.node_rows[lvl] + (self.level_base[lvl] + offset)
        return rows[row, pixel]

    def fuzzy_offset(self) -> int:
        """A fuzzy node's first row after its own first: past the node's
        two shadow rows a light."""
        return 2 * self.n_lights if self.soft_jit else 0

    def has_fuzzy(self, lvl: int) -> bool:
        return self.fuzzy and lvl < self.shape.n_levels - 1


class NodeDraws(NamedTuple):
    """The trace values of one level's rays: ``rows`` [n_rows, R] (after
    ``stream_rows``; None when the layout has none) read in the sweep's
    slot order, or, with ``pixel`` and ``path`` [n] int64, for queue
    entries at those nodes."""

    layout: StreamLayout
    lvl: int
    rows: Optional[torch.Tensor]
    pixel: Optional[torch.Tensor] = None
    path: Optional[torch.Tensor] = None

    def values(self, offset: int) -> torch.Tensor:
        if self.pixel is None:
            return self.layout.level_values(self.rows, self.lvl, offset)
        return self.layout.node_values(self.rows, self.lvl, offset,
                                       self.pixel, self.path)

    def jitter(self):
        """Per light, the (jx, jy) light offsets of jittered soft shadows;
        None without them."""
        if not self.layout.soft_jit:
            return None
        return [(self.values(2 * li), self.values(2 * li + 1))
                for li in range(self.layout.n_lights)]

    def sphere(self):
        """[n, 3] unit-sphere points of fuzzy reflection at a spawning
        level; None without them."""
        if not self.layout.has_fuzzy(self.lvl):
            return None
        off = self.layout.fuzzy_offset()
        return torch.stack([self.values(off + k) for k in range(3)], dim=-1)


@functools.lru_cache(maxsize=64)
def stream_layout(has_refl: bool, has_refr: bool, n_lights: int,
                  cfg: RenderConfig) -> StreamLayout:
    """The layout of ``_stream_layout`` for a scene's static shape (made
    once per shape and config: a frame asks for it at every subpixel and
    level, and a compiled frame at every call)."""
    shape = tree_shape(has_refl, has_refr, cfg.max_depth)
    soft_jit = bool(cfg.soft_shadow and cfg.anti_aliasing)
    fuzzy = bool(cfg.fuzzy_reflection and has_refl)
    has_sec = has_refl or has_refr
    rowmap, bases, per_node = {}, [], []
    n, w = 0, 1
    for lvl in range(shape.n_levels):
        spawn = has_sec and lvl < shape.n_levels - 1
        bases.append(n)
        per_node.append(2 * n_lights * soft_jit + 3 * (spawn and fuzzy))
        for path in range(w):
            if soft_jit:
                for li in range(n_lights):
                    rowmap[("shadow", lvl, path, li)] = (n, n + 1)
                    n += 2
            if spawn and fuzzy:
                rowmap[("fuzzy", lvl, path)] = (n, n + 1, n + 2)
                n += 3
        if spawn:
            w *= shape.branch
    return StreamLayout(n, rowmap, shape, n_lights, soft_jit, fuzzy,
                        tuple(bases), tuple(per_node))


def scene_layout(scene, cfg: RenderConfig) -> StreamLayout:
    return stream_layout(bool(scene.has_reflective),
                         bool(scene.has_transmissive), scene.n_lights, cfg)


class Draws(NamedTuple):
    """One subpixel's draws (module doc); None where the config needs
    none."""

    ij: Optional[tuple]               # (i, j) subpixel indices under AA
    jitter: Optional[torch.Tensor]    # [R, 2] raw
    time: Optional[torch.Tensor]      # [R] raw
    lens: Optional[torch.Tensor]      # [R, 2] raw
    rows: Optional[torch.Tensor]      # [n_rows, R] raw


def subpixels(cfg: RenderConfig) -> list:
    """The (i, j) subpixel indices of the AA scan (main.cpp:777-798), row
    i outer; [None] without AA."""
    if not cfg.anti_aliasing:
        return [None]
    spp = max(cfg.spp, 1)
    return [(float(i), float(j)) for i in range(spp) for j in range(spp)]


def stream_rows(raw: torch.Tensor, layout: StreamLayout, ij,
                spp: int) -> torch.Tensor:
    """[n_rows, R] values of the raw U[0,1) rows ``raw``: a shadow row
    0.5·((i + u)/spp) (x offset) or 0.5·((j + u)/spp) (y offset)
    (main.cpp:621-624); a fuzzy node's three rows the unit-sphere point of
    its three draws (ops/sampling.unit_sphere_from_uniforms). A level's
    nodes are read as one strided view, with no index tensor (one made from
    a list would be copied from host memory, which a CUDA graph cannot
    capture)."""
    out = raw.clone()
    i, j = ij if ij is not None else (0.0, 0.0)
    spp = max(spp, 1)
    L2 = 2 * layout.n_lights
    for lvl in range(layout.shape.n_levels):
        step = layout.node_rows[lvl]
        if not step:
            continue
        base = layout.level_base[lvl]
        n = layout.shape.branch ** lvl * step
        src = raw[base:base + n].view(-1, step, raw.shape[-1])
        dst = out[base:base + n].view(-1, step, raw.shape[-1])
        if layout.soft_jit:
            dst[:, 0:L2:2] = 0.5 * ((i + src[:, 0:L2:2]) / spp)
            dst[:, 1:L2:2] = 0.5 * ((j + src[:, 1:L2:2]) / spp)
        if layout.has_fuzzy(lvl):
            o = layout.fuzzy_offset()
            s = unit_sphere_from_uniforms(src[:, o], src[:, o + 1],
                                          src[:, o + 2])
            dst[:, o:o + 3] = s.movedim(-1, 1)
    return out


def draw_subpixel(generator: torch.Generator, layout: StreamLayout,
                  cfg: RenderConfig, R: int, ij) -> Draws:
    """One subpixel's draws from ``generator``, in the order jitter, time,
    lens, rows."""
    jitter = uniform(generator, (R, 2)) if cfg.anti_aliasing else None
    time = uniform(generator, (R,)) if cfg.motion_blur else None
    lens = uniform(generator, (R, 2)) if cfg.depth_of_field else None
    rows = uniform(generator, (layout.n_rows, R)) if layout.n_rows else None
    return Draws(ij, jitter, time, lens, rows)


def draw_plan(generator: torch.Generator, layout: StreamLayout,
              cfg: RenderConfig, R: int) -> list:
    """Every subpixel's draws for a tile of R pixels."""
    return [draw_subpixel(generator, layout, cfg, R, ij)
            for ij in subpixels(cfg)]


def draw_bytes(layout: StreamLayout, cfg: RenderConfig, R: int) -> int:
    """Bytes of f32 draws one subpixel holds."""
    per_ray = (2 * cfg.anti_aliasing + cfg.motion_blur
               + 2 * cfg.depth_of_field + layout.n_rows)
    return 4 * R * per_ray
