"""The benchmark's scene inputs, made from a configuration file.

A scene is a plain description in NumPy (``Description``): the camera, the
lights, the material rows and the objects in the order they were added.
Both sides take it as it is: the harness hands it to the program through
its scene definition (``to_scene_def``: the ``add_*`` calls a ``.p3f``
parser makes) and the reference builds its own tables from it
(``reference/whitted.build``). Nothing here imports the program: the
program's module is passed in.

A configuration names a builder and its arguments and nothing else:
``spd_balls`` builds the SPD "balls" database (the sphereflake, the class
of the reference's balls_high.p3f) from its published procedure, and
``mount`` is the reference's mount_low.p3f, number for number a copy of
the port's ``models/scenes.mount_scene``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

TRIANGLE = 1
SPHERE = 2


@dataclasses.dataclass
class Description:
    """A scene as plain arrays. ``kind`` [N] is TRIANGLE or SPHERE in the
    order the objects were added; ``data`` [N, 9] holds a triangle's three
    vertices or a sphere's centre and radius (then zeros); ``mat`` [N] the
    material row of each; ``materials`` [M, 11] (diffuse rgb, kd, specular
    rgb, ks, shine, transmit, ior); ``lights`` [L, 6] (position, colour)."""

    camera: dict
    bg: np.ndarray
    kind: list = dataclasses.field(default_factory=list)
    data: list = dataclasses.field(default_factory=list)
    mat: list = dataclasses.field(default_factory=list)
    materials: list = dataclasses.field(default_factory=list)
    lights: list = dataclasses.field(default_factory=list)

    def material(self, diff, kd, spec, ks, shine, t, ior) -> int:
        self.materials.append(
            np.array([*diff, kd, *spec, ks, shine, t, ior], np.float32))
        return len(self.materials) - 1

    def sphere(self, centre, radius, m) -> None:
        row = np.zeros(9, np.float32)
        row[:4] = np.asarray([*centre, radius], np.float32)
        self.kind.append(SPHERE)
        self.data.append(row)
        self.mat.append(m)

    def triangle(self, a, b, c, m) -> None:
        self.kind.append(TRIANGLE)
        self.data.append(np.asarray([*a, *b, *c], np.float32))
        self.mat.append(m)

    def light(self, pos, colour) -> None:
        self.lights.append(np.array([*pos, *colour], np.float32))


def _camera(eye, at, up, fov, res, focal_ratio) -> dict:
    return dict(eye=np.asarray(eye, np.float32),
                at=np.asarray(at, np.float32),
                up=np.asarray(up, np.float32), fov=float(fov), hither=0.01,
                res_x=int(res), res_y=int(res), aperture_ratio=0.0,
                focal_ratio=float(focal_ratio))


def _rotation(axis, angle: float) -> np.ndarray:
    """[3, 3]: the right-handed rotation by ``angle`` about ``axis``."""
    u = np.asarray(axis, np.float64)
    u = u / np.linalg.norm(u)
    k = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
    return (math.cos(angle) * np.eye(3) + math.sin(angle) * k
            + (1 - math.cos(angle)) * np.outer(u, u))


def _bloom() -> np.ndarray:
    """[9, 3]: the directions of a sphere's nine children about +z (balls.c's
    ``create_objset``): a trio of cube-edge directions tilted about
    (1, -1, 0) by asin(2 / sqrt 6), then turned by 0, 120 and 240 degrees
    about z. Three children sit 54.7 degrees up, six on the equator."""
    d = 1 / math.sqrt(2)
    trio = np.array([[d, d, 0], [d, 0, -d], [0, d, -d]])
    trio = trio @ _rotation([1, -1, 0], math.asin(2 / math.sqrt(6))).T
    return np.concatenate([trio @ _rotation([0, 0, 1], k * 2 * math.pi / 3).T
                           for k in range(3)])


def _frame(direction: np.ndarray) -> np.ndarray:
    """[3, 3]: the rotation that takes +z to ``direction``, about their
    cross product; straight down, a half turn about y."""
    if direction[2] >= 1 - 1e-12:
        return np.eye(3)
    if direction[2] <= -1 + 1e-12:
        return _rotation([0, 1, 0], math.pi)
    return _rotation(np.cross([0.0, 0.0, 1.0], direction),
                     math.acos(direction[2]))


def spd_balls(size: int = 4, res: int = 512) -> Description:
    """The SPD "balls" database (the sphereflake; Haines, "A Proposal for
    Standard Graphics Environments", IEEE CG&A 7(11), 1987): a sphere of
    radius 0.5 at the origin, each sphere bearing nine tangent children a
    third its radius, ``size`` levels deep (4: 7,381 spheres), over a
    24-unit square floor at z = -0.5, three white lights. NFF's
    materials as P3D writes them (white specular colour): the floor
    diffuse only, the spheres half diffuse, half mirror. Numbers to six
    significant digits, as NFF's ``%g`` writes them; NFF's square floor as
    two triangles, since a P3D ``p`` is a triangle."""
    sd = Description(
        camera=_camera([2.1, 1.3, 1.7], [0, 0, 0], [0, 0, 1], 45, res, 1),
        bg=np.array([0.078, 0.361, 0.753], np.float32))
    for pos in ([4, 3, 2], [1, -4, 4], [-3, 1, 5]):
        sd.light(pos, [1, 1, 1])
    floor = sd.material([1, 0.75, 0.33], 0.8, [1, 1, 1], 0, 0, 0, 1)
    v = [[12, 12, -0.5], [-12, 12, -0.5], [-12, -12, -0.5], [12, -12, -0.5]]
    sd.triangle(v[0], v[1], v[2], floor)
    sd.triangle(v[0], v[2], v[3], floor)
    shiny = sd.material([1, 0.9, 0.7], 0.5, [1, 1, 1], 0.5, 3.0827, 0, 1)
    bloom = _bloom()

    def grow(centre, radius, direction, depth):
        sd.sphere([float(f"{x:g}") for x in centre], float(f"{radius:g}"),
                  shiny)
        if depth == 0:
            return
        turn = _frame(direction)
        for w in bloom @ turn.T:
            grow(centre + w * radius * (4 / 3), radius / 3, w, depth - 1)

    grow(np.zeros(3), 0.5, np.array([0.0, 0.0, 1.0]), int(size))
    return sd


def mount(res: int = 512) -> Description:
    """mount_low.p3f: four glass spheres (ior 1.6) over a mountain of eight
    triangles, one far light (the port's ``mount_scene``)."""
    sd = Description(
        camera=_camera([-1.6, 1.6, 1.7], [0, 0, 0], [0, 0, 1], 45, res, 0.7),
        bg=np.array([0.078, 0.361, 0.753], np.float32))
    sd.light([-100, -100, 100], [1, 1, 1])
    glass = sd.material([1, 1, 1], 0.1, [1, 1, 1], 0.1, 101.148, 1, 1.6)
    sd.sphere([-0.8, 0.8, 1.20821], 0.17, glass)
    sd.sphere([-0.661196, 0.661196, 0.930598], 0.169, glass)
    sd.sphere([-0.749194, 0.98961, 0.930598], 0.168, glass)
    sd.sphere([-0.98961, 0.749194, 0.930598], 0.167, glass)
    rock = sd.material([0.5, 0.45, 0.35], 1, [1, 1, 1], 0, 1000, 0, 0)
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
        sd.triangle(a, b, c, rock)
    return sd


BUILDERS = {"spd_balls": spd_balls, "mount": mount}


def describe(config: dict) -> Description:
    """The scene of a configuration file: ``config["scene"]`` names a
    builder, ``config["scene_args"]`` its arguments."""
    return BUILDERS[config["scene"]](**config.get("scene_args", {}))


def to_scene_def(desc: Description, p3f, accel: int):
    """The program's scene definition (``io/p3f.SceneDef``, passed in as
    the module ``p3f``) of ``desc``, under the accelerator ``accel``."""
    sd = p3f.SceneDef()
    sd.accel_type = int(accel)
    sd.spp = 0
    sd.bg_color = desc.bg.copy()
    cam = desc.camera
    sd.set_camera(eye=cam["eye"], at=cam["at"], up=cam["up"], fov=cam["fov"],
                  hither=cam["hither"], res_x=cam["res_x"],
                  res_y=cam["res_y"], aperture_ratio=cam["aperture_ratio"],
                  focal_ratio=cam["focal_ratio"])
    for row in desc.lights:
        sd.add_light(row[:3], row[3:])
    for row in desc.materials:
        sd.add_material(row[0:3], row[3], row[4:7], row[7], row[8], row[9],
                        row[10])
    for kind, row, m in zip(desc.kind, desc.data, desc.mat):
        if kind == SPHERE:
            sd.add_sphere(row[:3], row[3], m)
        else:
            sd.add_triangle(row[0:3], row[3:6], row[6:9], m)
    return sd
