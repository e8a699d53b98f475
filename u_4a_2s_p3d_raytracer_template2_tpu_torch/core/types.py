"""Scene, ray, camera and config types: frozen dataclasses of tensors.

The counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/core/types.py``.
The reference stores its scene as a vector of polymorphic ``Object*``
(reference: scene.h:67-145); here it is one unified SoA primitive table plus
type-grouped views, so every intersection test is a dense op over one type.

Parameter block layout by type (``ptype``):
  PLANE    : pn(3), d(1)                      — scene.cpp:90-147
  TRIANGLE : v0(3), e1(3), e2(3), normal(3)   — scene.cpp:10-88
  SPHERE   : center(3), radius(1)             — scene.cpp:149-186
  AABOX    : min(3), max(3)                   — scene.cpp:188-283

A BVH or grid scene carries the port's BVH tables in ``Scene.packets``
(``accel/packets.py``); the JAX scene's reference BVH, grid and cluster tables
have no counterpart yet (ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from . import constants as C


@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table (reference: scene.h:23-55)."""

    diff_color: torch.Tensor  # [M, 3]
    kd: torch.Tensor          # [M]
    spec_color: torch.Tensor  # [M, 3]
    ks: torch.Tensor          # [M]
    shine: torch.Tensor       # [M]
    transmit: torch.Tensor    # [M]  (T)
    ior: torch.Tensor         # [M]


@dataclasses.dataclass(frozen=True)
class Lights:
    """Point lights (reference: scene.h:57-65)."""

    position: torch.Tensor  # [L, 3]
    color: torch.Tensor     # [L, 3]


@dataclasses.dataclass(frozen=True)
class Primitives:
    """Unified primitive table padded to a multiple of 8, plus type-grouped
    views. ``*_ids`` map view rows back to global object indices (-1 =
    padding)."""

    params: torch.Tensor   # [N, 12] f32
    ptype: torch.Tensor    # [N] i32
    mat_id: torch.Tensor   # [N] i32
    tri_p: torch.Tensor    # [Kt, 12] (v0, e1, e2, normal)
    tri_ids: torch.Tensor  # [Kt]
    sph_p: torch.Tensor    # [Ks, 4]  (center, radius)
    sph_ids: torch.Tensor  # [Ks]
    pl_p: torch.Tensor     # [Kp, 4]  (pn, d)
    pl_ids: torch.Tensor   # [Kp]
    box_p: torch.Tensor    # [Kb, 6]  (min, max)
    box_ids: torch.Tensor  # [Kb]
    n_tri: int = 0
    n_sph: int = 0
    n_pl: int = 0
    n_box: int = 0


@dataclasses.dataclass(frozen=True)
class Camera:
    """uvn camera frame (reference: camera.h:12-128); scalars are 0-d
    tensors."""

    eye: torch.Tensor          # [3]
    u: torch.Tensor            # [3]
    v: torch.Tensor            # [3]
    n: torch.Tensor            # [3]
    w: torch.Tensor            # [] view-plane width
    h: torch.Tensor            # [] view-plane height
    plane_dist: torch.Tensor   # []
    focal_ratio: torch.Tensor  # []
    aperture: torch.Tensor     # [] aperture_ratio * pixel size
    time0: torch.Tensor        # [] shutter open
    time1: torch.Tensor        # [] shutter close
    res_x: int = 512
    res_y: int = 512


@dataclasses.dataclass(frozen=True)
class Scene:
    """A whole scene on one device."""

    prims: Primitives
    materials: Materials
    lights: Lights
    camera: Camera
    bg_color: torch.Tensor  # [3]
    # [6, H, W, 3] cubemap: uint8 when loaded from an ``env`` directory
    # (io/skybox.py), float32 when a caller gives a synthetic one; None when
    # the scene has none (then has_skybox is False)
    skybox: Optional[torch.Tensor] = None
    has_skybox: bool = False
    accel_type: int = C.ACCEL_NONE
    spp: int = 0
    n_objects: int = 0
    n_lights: int = 0
    # static material-population facts: when False, that child subtree of
    # the Whitted recursion can never spawn (main.cpp:646 spawns reflection
    # only for Ks>0; main.cpp:671 refraction only for T!=0)
    has_reflective: bool = True
    has_transmissive: bool = True
    # the BVH walk's tables (accel.packets.PacketTables) of a BVH or grid
    # scene with at least one bounded primitive; None otherwise
    packets: Optional[Any] = None
    # the brute-force kernels' tables (ops.intersect.BruteTables) of the
    # triangles and spheres, packed once per scene
    brute: Optional[Any] = None
    # data an engine derives from the scene once and reuses on every frame
    # (the megakernel's packed tables); not part of the scene's value, and
    # dataclasses.replace starts a new one
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.bg_color.device


@dataclasses.dataclass(frozen=True)
class Rays:
    """SoA ray batch (reference: ray.h:6-21)."""

    origin: torch.Tensor     # [R, 3]
    direction: torch.Tensor  # [R, 3]
    time: torch.Tensor       # [R]

    @staticmethod
    def make(origin: torch.Tensor, direction: torch.Tensor,
             time: torch.Tensor | None = None) -> "Rays":
        if time is None:
            time = origin.new_zeros(origin.shape[:-1])
        return Rays(origin, direction, time)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Feature flags mirroring the reference's compile-time bools
    (main.cpp:40-48) plus explicit switches for the reference's quirks.
    Copied field for field, defaults included, from the JAX package's
    ``RenderConfig``; fields the port does not serve yet (the wavefront
    engine) raise where they are used.

    Modes marked ``reference_*`` replicate shipped reference behavior including
    its bugs; the defaults are the physically-correct variants.
    """

    max_depth: int = C.MAX_DEPTH
    anti_aliasing: bool = False
    soft_shadow: bool = False
    depth_of_field: bool = False
    fuzzy_reflection: bool = False
    motion_blur: bool = False
    spp: int = 0                    # grid side; samples = spp*spp (main.cpp:777-798)
    roughness: float = 0.3          # fuzzy reflection roughness (main.cpp:653)

    # Fresnel handling at transmissive hits (main.cpp:699-716):
    #   "schlick"           — physical Schlick; KR=1 on total internal reflection
    #   "reference_schlick" — Schlick, but KR=0 on TIR (int-division bug path)
    #   "reference_exact"   — KR=0 always (dead exact-Fresnel branch, main.cpp:711)
    fresnel_mode: str = "schlick"

    # Refraction direction (main.cpp:671-697):
    #   "physical"  — Snell's law transmitted direction
    #   "reference" — the reference's tangent*sin_t + unit-normal formula
    refraction_mode: str = "reference"

    # NONE-mode shadow rays use unnormalized L and unbounded max-t
    # (main.cpp:476-509). False = bound by light distance.
    shadow_unbounded: bool = False

    # Grid shadow rays whose Init_Traverse fails are treated as occluded by
    # the reference (grid.cpp:326-328). False = physical (grid miss = lit).
    reference_grid_shadow_initfail: bool = False

    # AA averaging: reference divides by 4*4 regardless of spp (main.cpp:800).
    reference_aa_div16: bool = False

    # Use the skybox cubemap on miss when the scene has one.
    use_skybox: bool = False

    shutter: tuple[float, float] = (0.0, 1.0)  # main.cpp:47-48

    # Secondary-ray engine: "sweep" = full 2^l level sweep in PyTorch;
    # "megakernel" = the hand-written CUDA kernel on CUDA tensors, its plain
    # version on CPU tensors (models/whitted_megakernel.py); "wavefront" is
    # not ported yet.
    engine: str = "sweep"
    wavefront_capacity: float = 1.0
    wavefront_defer_sky: bool = False
    megakernel_interpret: bool = False

    # BVH- and grid-mode traversal (models/whitted._bvh_impl): "auto",
    # "packets", "clusters" and "multi" walk the scene's BVH tables
    # ("multi" also fuses a hit's hard-shadow queries over its lights into
    # one launch); "brute" tests every primitive; "perray" (the reference
    # BVH walk and grid DDA) is not ported yet and raises.
    accel_impl: str = "auto"

    def with_scene_flags(self, scene: Scene) -> "RenderConfig":
        """Apply the reference's init-time coupling: spp>0 enables AA+DoF
        ("Distribution Ray-Tracing", main.cpp:939-946)."""
        if scene.spp > 0:
            return dataclasses.replace(
                self, spp=scene.spp, anti_aliasing=True, depth_of_field=True
            )
        return self


# ---------------------------------------------------------------------------
# small vector helpers (the Vector/Color algebra of vector.cpp / color.h)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Safe normalize: zero vectors map to zero."""
    n2 = (a * a).sum(-1, keepdim=True)
    ok = n2 > 0.0
    return torch.where(ok, a / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)


def clamp01(c: torch.Tensor) -> torch.Tensor:
    """Color::clamp (color.h:38-43)."""
    return c.clamp(0.0, 1.0)
