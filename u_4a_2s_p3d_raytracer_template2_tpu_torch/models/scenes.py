"""Programmatic scenes, copied from
``u_4a_2s_p3d_raytracer_template2_tpu/models/scenes.py`` (NumPy only).

``mount_scene`` reproduces the primary benchmark scene geometry
(P3D_Scenes/mount_low.p3f: 8 triangles forming a mountain, 4 transmissive
spheres with ior 1.6, one light) so the port renders it without the reference
checkout; ``mount_distribution_scene`` is the same in distribution mode with
a skybox, whose faces ``synthetic_skybox`` makes from a seed. ``sphere_field_scene`` is the deterministic sphere field of the
balls_high shape; ``random_scene`` the RTiOW-style generator
(scene.cpp:677-751).
"""
from __future__ import annotations

import numpy as np

from ..core import constants as C
from ..io.p3f import SceneDef


def mount_scene(res: int = 512, accel: int = C.ACCEL_NONE) -> SceneDef:
    """The mount_low benchmark scene: refractive sphere cluster over a
    triangle 'mountain' (mount_low.p3f)."""
    sd = SceneDef()
    sd.accel_type = accel
    sd.spp = 0
    sd.bg_color = np.array([0.078, 0.361, 0.753], np.float32)
    sd.set_camera(eye=[-1.6, 1.6, 1.7], at=[0, 0, 0], up=[0, 0, 1],
                  fov=45, hither=0.01, res_x=res, res_y=res,
                  aperture_ratio=0, focal_ratio=0.7)
    sd.add_light([-100, -100, 100], [1, 1, 1])

    glass = sd.add_material([1, 1, 1], 0.1, [1, 1, 1], 0.1, 101.148, 1, 1.6)
    sd.add_sphere([-0.8, 0.8, 1.20821], 0.17, glass)
    sd.add_sphere([-0.661196, 0.661196, 0.930598], 0.169, glass)
    sd.add_sphere([-0.749194, 0.98961, 0.930598], 0.168, glass)
    sd.add_sphere([-0.98961, 0.749194, 0.930598], 0.167, glass)

    # f 0.5 0.45 0.35 1 | 1 1 1 0 | 1000 0 0 — Ks is 0 in mount_low.p3f
    rock = sd.add_material([0.5, 0.45, 0.35], 1, [1, 1, 1], 0, 1000, 0, 0)
    peak = [0.0, 0.0, 0.529551]
    rim = [
        [-1, -1, 0], [0, -1, -0.5481], [1, -1, 0], [1, 0, 0.657244],
        [1, 1, 0], [0, 1, -0.00294902], [-1, 1, 0], [-1, 0, -0.314742],
    ]
    tris = [
        (rim[0], rim[1], peak), (peak, rim[7], rim[0]),
        (rim[1], rim[2], rim[3]), (rim[3], peak, rim[1]),
        (peak, rim[3], rim[4]), (rim[4], rim[5], peak),
        (rim[7], peak, rim[5]), (rim[5], rim[6], rim[7]),
    ]
    for a, b, c in tris:
        sd.add_triangle(a, b, c, rock)
    return sd


# mount_distribution_scene's lens, in pixels (camera.h:66): at 512x512 it
# blurs mount_low's spheres visibly off the focal plane.
DISTRIBUTION_APERTURE_RATIO = 8.0


def mount_distribution_scene(res: int = 512, skybox_dir=None) -> SceneDef:
    """mount_low in the reference's distribution mode: spp 4, the AA grid
    side (``RenderConfig.with_scene_flags`` turns on AA and DoF, as
    balls_low.p3f and dof.p3f ship), a lens of DISTRIBUTION_APERTURE_RATIO
    pixels with the focal plane at mount_low's focal_ratio 0.7, and the
    ``env`` cubemap directory ``skybox_dir``."""
    sd = mount_scene(res)
    sd.spp = 4
    sd.camera["aperture_ratio"] = DISTRIBUTION_APERTURE_RATIO
    sd.skybox_dir = skybox_dir
    return sd


def synthetic_skybox(size: int = 2048, seed: int = 0) -> np.ndarray:
    """[6, size, size, 3] u8 cubemap made from ``seed``: a smooth gradient
    in a tint of its own on each face, plus noise (sigma 6 of 255), so
    neighbouring texels differ and a wrong texel shows."""
    rng = np.random.default_rng(seed)
    tints = rng.uniform(0.2, 1.0, (6, 3)).astype(np.float32)
    ramp = np.linspace(0.0, 1.0, size, dtype=np.float32)
    grad = 0.3 + 0.35 * (ramp[:, None] + ramp[None, :])
    out = np.empty((6, size, size, 3), np.uint8)
    for f in range(6):
        v = grad[:, :, None] * tints[f] * 255.99
        v = v + 6.0 * rng.standard_normal((size, size, 3), dtype=np.float32)
        out[f] = np.clip(v, 0.0, 255.0).astype(np.uint8)
    return out


def sphere_field_scene(n_side: int = 16, res: int = 512,
                       accel: int = C.ACCEL_BVH, seed: int = 7) -> SceneDef:
    """A large deterministic sphere field for accel/scaling benchmarks
    (the balls_high stress-scene shape)."""
    rng = np.random.default_rng(seed)
    sd = SceneDef()
    sd.accel_type = accel
    sd.spp = 0
    sd.bg_color = np.array([0.078, 0.361, 0.753], np.float32)
    sd.set_camera(eye=[0, -2.5 * n_side / 8, 1.5], at=[0, 0, 0],
                  up=[0, 0, 1], fov=45, hither=0.01, res_x=res, res_y=res,
                  aperture_ratio=0, focal_ratio=1)
    sd.add_light([4, 3, 2], [1, 1, 1])
    sd.add_light([-3, 1, 5], [1, 1, 1])
    base = sd.add_material([1, 0.75, 0.33], 1, [1, 1, 1], 0.8, 10, 0, 1)
    sd.add_triangle([12, 12, -0.5], [-12, 12, -0.5], [-12, -12, -0.5], base)
    sd.add_triangle([-12, -12, -0.5], [12, -12, -0.5], [12, 12, -0.5], base)
    for i in range(n_side):
        for j in range(n_side):
            x = (i - n_side / 2) * 0.6
            y = (j - n_side / 2) * 0.6
            kind = rng.uniform()
            if kind < 0.6:
                m = sd.add_material(rng.uniform(0.2, 1, 3), 1.0,
                                    [1, 1, 1], 0.0, 10, 0, 1)
            elif kind < 0.9:
                m = sd.add_material([0, 0, 0], 0.0,
                                    rng.uniform(0.5, 1, 3), 1.0, 220, 0, 1)
            else:
                m = sd.add_material([0, 0, 0], 0.0, [1, 1, 1],
                                    0.7, 20, 1, 1.5)
            sd.add_sphere([x, y, rng.uniform(-0.3, 0.0)],
                          rng.uniform(0.15, 0.28), m)
    return sd


def random_scene(res_x: int = 800, res_y: int = 600, seed: int = 0) -> SceneDef:
    """RTiOW-style random scene (create_random_scene, scene.cpp:677-751):
    ground sphere + 10x10 grid of diffuse/metal/glass spheres + 3 heroes,
    BVH accel, 3 lights."""
    rng = np.random.default_rng(seed)
    sd = SceneDef()
    sd.accel_type = C.ACCEL_BVH
    sd.spp = 0
    sd.bg_color = np.array([0.5, 0.7, 1.0], np.float32)
    sd.set_camera(eye=[-5.312192, 4.456562, 11.963158], at=[0, 0, 0],
                  up=[0, 1, 0], fov=45, hither=0.01, res_x=res_x, res_y=res_y,
                  aperture_ratio=0, focal_ratio=1.5)
    for pos in ([7, 10, -5], [-7, 10, -5], [0, 10, 7]):
        sd.add_light(pos, [1, 1, 1])

    ground = sd.add_material([0.5, 0.5, 0.5], 1.0, [0, 0, 0], 0.0, 10, 0, 1)
    sd.add_sphere([0, -1000, 0], 1000.0, ground)

    for a in range(-5, 5):
        for b in range(-5, 5):
            choose = rng.uniform()
            center = np.array([a + 0.9 * rng.uniform(), 0.2,
                               b + 0.9 * rng.uniform()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.4:
                m = sd.add_material(rng.uniform(0, 1, 3), 1.0,
                                    [0, 0, 0], 0.0, 10, 0, 1)
            elif choose < 0.9:
                m = sd.add_material([0, 0, 0], 0.0,
                                    rng.uniform(0.5, 1, 3), 1.0, 220, 0, 1)
            else:
                m = sd.add_material([0, 0, 0], 0.0, [1, 1, 1],
                                    0.7, 20, 1, 1.5)
            sd.add_sphere(center, 0.2, m)

    glass = sd.add_material([0, 0, 0], 0.0, [1, 1, 1], 0.7, 20, 1, 1.5)
    sd.add_sphere([0, 1, 0], 1.0, glass)
    brown = sd.add_material([0.4, 0.2, 0.1], 0.9, [1, 1, 1], 0.1, 10, 0, 1)
    sd.add_sphere([-4, 1, 0], 1.0, brown)
    metal = sd.add_material([0.4, 0.2, 0.1], 0.0, [0.7, 0.6, 0.5], 1.0,
                            220, 0, 1)
    sd.add_sphere([4, 1, 0], 1.0, metal)
    return sd
