"""``.p3f`` scene-file parser → host-side SceneDef (NumPy).

Grammar per the reference parser (scene.cpp:476-675): whitespace-separated
tokens; commands ``accel``, ``spp``, ``f`` (material, sticky for subsequent
primitives), ``s`` (sphere), ``box``, ``p 3`` (triangle), ``mesh`` (vertex/face
lists, 1-based or negative indices, scene.cpp:568-580), ``pl`` (plane from 3
points), ``l`` (light), ``v`` (camera block with from/at/up/angle/hither/
resolution/aperture/focal), ``bclr``, ``env <dir>``, ``#`` comments.

A copy of ``u_4a_2s_p3d_raytracer_template2_tpu/io/p3f.py``: that module is
NumPy only, but importing it runs the JAX package's ``__init__``, which
imports jax.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..core import constants as C


@dataclasses.dataclass
class ObjectDef:
    ptype: int
    params: np.ndarray  # [12] f32
    mat_id: int


@dataclasses.dataclass
class SceneDef:
    """Host-side parsed scene, before padding/device upload."""

    objects: list[ObjectDef] = dataclasses.field(default_factory=list)
    materials: list[np.ndarray] = dataclasses.field(default_factory=list)  # [11]
    lights: list[np.ndarray] = dataclasses.field(default_factory=list)     # [6]
    camera: Optional[dict] = None
    bg_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    accel_type: int = C.ACCEL_NONE
    spp: int = 0
    skybox_dir: Optional[str] = None

    # -- methods used by both the parser and programmatic scenes -----------

    def add_material(self, diff, kd, spec, ks, shine, t, ior) -> int:
        m = np.array([*diff, kd, *spec, ks, shine, t, ior], np.float32)
        self.materials.append(m)
        return len(self.materials) - 1

    def _pack(self, ptype: int, vals, mat_id: int):
        p = np.zeros(12, np.float32)
        v = np.asarray(vals, np.float32).ravel()
        p[: v.size] = v
        self.objects.append(ObjectDef(ptype, p, mat_id))

    def add_sphere(self, center, radius, mat_id):
        self._pack(C.SPHERE, [*center, radius], mat_id)

    def add_triangle(self, p0, p1, p2, mat_id):
        """Precompute v0/e1/e2/flat normal like the Triangle ctor (scene.cpp:10-40)."""
        p0 = np.asarray(p0, np.float32)
        e1 = np.asarray(p1, np.float32) - p0
        e2 = np.asarray(p2, np.float32) - p0
        n = np.cross(e1, e2)
        ln = np.linalg.norm(n)
        if ln > 0:
            n = n / ln
        self._pack(C.TRIANGLE, [*p0, *e1, *e2, *n], mat_id)

    def add_triangles_bulk(self, verts: np.ndarray, faces: np.ndarray,
                           mat_id: int):
        """Vectorized mesh ingestion (the 'mesh' keyword, scene.cpp:556-585):
        precompute v0/e1/e2/flat-normal for every face in one shot."""
        v0 = verts[faces[:, 0]].astype(np.float32)
        e1 = (verts[faces[:, 1]] - verts[faces[:, 0]]).astype(np.float32)
        e2 = (verts[faces[:, 2]] - verts[faces[:, 0]]).astype(np.float32)
        n = np.cross(e1, e2)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(ln > 0, n / np.where(ln > 0, ln, 1.0), 0.0)
        params = np.concatenate([v0, e1, e2, n], axis=-1).astype(np.float32)
        self.objects.extend(
            ObjectDef(C.TRIANGLE, params[i], mat_id)
            for i in range(params.shape[0])
        )

    def add_plane_points(self, p0, p1, p2, mat_id):
        """Plane from 3 CCW points (scene.cpp:94-113)."""
        p0 = np.asarray(p0, np.float32)
        pn = np.cross(
            np.asarray(p1, np.float32) - p0, np.asarray(p2, np.float32) - p0
        )
        ln = np.linalg.norm(pn)
        if ln == 0.0:
            raise ValueError("degenerate plane")
        pn = pn / ln
        d = -float(pn @ p0)
        self._pack(C.PLANE, [*pn, d], mat_id)

    def add_box(self, minp, maxp, mat_id):
        self._pack(C.AABOX, [*minp, *maxp], mat_id)

    def add_light(self, pos, color):
        self.lights.append(np.array([*pos, *color], np.float32))

    def set_camera(
        self, eye, at, up, fov, hither, res_x, res_y, aperture_ratio, focal_ratio
    ):
        self.camera = dict(
            eye=np.asarray(eye, np.float32),
            at=np.asarray(at, np.float32),
            up=np.asarray(up, np.float32),
            fov=float(fov),
            hither=float(hither),
            res_x=int(res_x),
            res_y=int(res_y),
            aperture_ratio=float(aperture_ratio),
            focal_ratio=float(focal_ratio),
        )


class _Tokens:
    """Word-token stream with '#'-to-EOL comment skipping (scene.cpp:659-662)."""

    def __init__(self, text: str):
        self._toks: list[str] = []
        for line in text.splitlines():
            for w in line.split():
                if w.startswith("#"):
                    break
                self._toks.append(w)
        self._i = 0

    def next(self) -> str:
        t = self._toks[self._i]
        self._i += 1
        return t

    def next_f(self) -> float:
        return float(self.next())

    def next_i(self) -> int:
        return int(self.next())

    def vec3(self) -> np.ndarray:
        return np.array([self.next_f(), self.next_f(), self.next_f()], np.float32)

    def take_floats(self, n: int) -> np.ndarray:
        out = np.array(self._toks[self._i:self._i + n], np.float32)
        self._i += n
        return out

    def take_ints(self, n: int) -> np.ndarray:
        out = np.array(self._toks[self._i:self._i + n], np.int64)
        self._i += n
        return out

    def expect(self, name: str):
        t = self.next()
        if t != name:
            raise ValueError(f"'{name}' expected, got '{t}'")

    def done(self) -> bool:
        return self._i >= len(self._toks)


def parse_p3f(path: str) -> SceneDef:
    with open(path, "r") as f:
        text = f.read()
    sd = parse_p3f_text(text)
    if sd.skybox_dir is not None and not os.path.isabs(sd.skybox_dir):
        sd.skybox_dir = os.path.join(os.path.dirname(os.path.dirname(path)),
                                     sd.skybox_dir)
    return sd


def parse_p3f_text(text: str) -> SceneDef:
    tk = _Tokens(text)
    sd = SceneDef()
    mat = -1  # sticky current material (scene.cpp:484)

    while not tk.done():
        cmd = tk.next()
        if cmd == "accel":
            sd.accel_type = tk.next_i()
        elif cmd == "spp":
            sd.spp = tk.next_i()
        elif cmd == "f":
            cd = tk.vec3()
            kd = tk.next_f()
            cs = tk.vec3()
            ks = tk.next_f()
            shine = tk.next_f()
            t = tk.next_f()
            ior = tk.next_f()
            mat = sd.add_material(cd, kd, cs, ks, shine, t, ior)
        elif cmd == "s":
            c = tk.vec3()
            r = tk.next_f()
            sd.add_sphere(c, r, mat)
        elif cmd == "box":
            mn = tk.vec3()
            mx = tk.vec3()
            sd.add_box(mn, mx, mat)
        elif cmd == "p":
            nv = tk.next_i()
            if nv != 3:
                raise ValueError("only triangles supported for 'p'")
            sd.add_triangle(tk.vec3(), tk.vec3(), tk.vec3(), mat)
        elif cmd == "mesh":
            nvert = tk.next_i()
            nface = tk.next_i()
            verts = tk.take_floats(nvert * 3).reshape(nvert, 3)
            faces = tk.take_ints(nface * 3).reshape(nface, 3)
            # 1-based or negative (wrapping) indices (scene.cpp:568-580)
            faces = np.where(faces[:, :1] > 0, faces - 1, faces + nvert)
            sd.add_triangles_bulk(verts, faces, mat)
        elif cmd == "pl":
            sd.add_plane_points(tk.vec3(), tk.vec3(), tk.vec3(), mat)
        elif cmd == "l":
            pos = tk.vec3()
            col = tk.vec3()
            sd.add_light(pos, col)
        elif cmd == "v":
            tk.expect("from")
            eye = tk.vec3()
            tk.expect("at")
            at = tk.vec3()
            tk.expect("up")
            up = tk.vec3()
            tk.expect("angle")
            fov = tk.next_f()
            tk.expect("hither")
            hither = tk.next_f()
            tk.expect("resolution")
            rx, ry = tk.next_i(), tk.next_i()
            tk.expect("aperture")
            ap = tk.next_f()
            tk.expect("focal")
            fr = tk.next_f()
            sd.set_camera(eye, at, up, fov, hither, rx, ry, ap, fr)
        elif cmd == "bclr":
            sd.bg_color = tk.vec3()
        elif cmd == "env":
            sd.skybox_dir = tk.next()
        else:
            raise ValueError(f"unknown command '{cmd}'")
    return sd
