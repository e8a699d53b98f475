"""The GLSL path-tracer world (P3D_RT.glsl:12-180), regenerated bit-exactly
host-side with the replicated uint-hash RNG (ops/glsl_hash.py); the
counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/models/glsl_scene.py``.

World: two ground triangles, three hero spheres (diffuse / metal / glass with
an optional hollow negative-radius shell), and a 10x10 procedural field of
diffuse / moving-diffuse / metal / fuzzy-metal / glass spheres keyed on
``seed = x + y/1000`` (P3D_RT.glsl:96). Three white point lights
(P3D_RT.glsl:247-254). The tables are built in NumPy, as in the JAX package,
and uploaded to the device the caller names.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.build import build_camera
from ..core.types import Camera
from ..ops.glsl_hash import SeedStream
from .pathtracer import (
    MT_DIELECTRIC,
    MT_DIFFUSE,
    MT_METAL,
    PTMaterials,
    PTScene,
)


def _pad(a, m, fill=0.0):
    a = np.asarray(a)
    n = a.shape[0]
    target = max(m, ((n + m - 1) // m) * m)
    out = np.full((target,) + a.shape[1:], fill, a.dtype)
    if n:
        out[:n] = a
    return out


def glsl_world(
    *,
    device,
    moving_seed: float = 0.5,
    showcase_fuzzy_reflections: bool = False,
    showcase_fuzzy_refractions: bool = False,
    no_negative_sphere: bool = False,
) -> PTScene:
    mats: list[tuple] = []  # (type, albedo3, spec3, rough, refidx, refract3)

    def add_mat(mtype, albedo=(0, 0, 0), spec=(0, 0, 0), rough=0.0,
                refidx=1.0, refract=(0, 0, 0)):
        mats.append((mtype, albedo, spec, rough, refidx, refract))
        return len(mats) - 1

    def diffuse(albedo):
        # createDiffuseMaterial (common.glsl:163-174)
        return add_mat(MT_DIFFUSE, albedo=albedo, rough=1.0)

    def metal(spec, rough):
        return add_mat(MT_METAL, spec=spec, rough=rough)

    def dielectric(refract, refidx, rough):
        # createDialectricMaterial: albedo=1, spec=0.04 (common.glsl:187-198)
        return add_mat(MT_DIELECTRIC, albedo=(1, 1, 1), spec=(.04, .04, .04),
                       rough=rough, refidx=refidx, refract=refract)

    tris = []   # (v0, v1, v2, mat)
    spheres = []  # (c0, c1, radius, t0, t1, mat)

    g = diffuse((0.2, 0.2, 0.2))
    tris.append(((-10, -0.01, 10), (10, -0.01, 10), (-10, -0.01, -10), g))
    tris.append(((-10, -0.01, -10), (10, -0.01, 10), (10, -0.01, -10), g))

    def sphere(c, r, m):
        spheres.append((c, c, r, 0.0, 0.0, m))

    sphere((-4, 1, 0), 1.0, diffuse((0.4, 0.2, 0.1)))
    sphere((4, 1, 0), 1.0,
           metal((0.7, 0.6, 0.5),
                 0.3 if showcase_fuzzy_reflections else 0.0))
    d_rough = 0.3 if showcase_fuzzy_refractions else 0.0
    sphere((0, 1, 0), 1.0, dielectric((0, 0, 0), 1.333, d_rough))
    if not no_negative_sphere:
        sphere((0, 1, 0), -0.5, dielectric((0, 0, 0), 1.333, d_rough))

    gseed = SeedStream(moving_seed)  # stand-in for the frame-varying gSeed
    for x in range(-5, 5):
        for y in range(-5, 5):
            fx, fy = float(x), float(y)
            ss = SeedStream(np.float32(fx + fy / 1000.0))
            rand1 = ss.hash3()
            center = np.array([fx + 0.9 * rand1[0], 0.2,
                               fy + 0.9 * rand1[1]])
            choose = rand1[2]
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.3:
                center1 = center + np.array([0.0, gseed.hash1() * 0.5, 0.0])
                alb = ss.hash3() * ss.hash3()
                spheres.append((tuple(center), tuple(center1), 0.2, 0.0, 1.0,
                                diffuse(tuple(alb))))
            elif choose < 0.5:
                alb = ss.hash3() * ss.hash3()
                sphere(tuple(center), 0.2, diffuse(tuple(alb)))
            elif choose < 0.7:
                spec = (ss.hash3() + 1.0) * 0.5
                sphere(tuple(center), 0.2, metal(tuple(spec), 0.0))
            elif choose < 0.9:
                spec = (ss.hash3() + 1.0) * 0.5
                sphere(tuple(center), 0.2, metal(tuple(spec), ss.hash1()))
            else:
                refract = ss.hash3()
                sphere(tuple(center), 0.2, dielectric(tuple(refract), 1.2, 0.0))

    sp = np.array([s[0] for s in spheres], np.float32)
    sp1 = np.array([s[1] for s in spheres], np.float32)
    rad = np.array([s[2] for s in spheres], np.float32)
    st0 = np.array([s[3] for s in spheres], np.float32)
    st1 = np.array([s[4] for s in spheres], np.float32)
    smat = np.array([s[5] for s in spheres], np.int32)

    tv0 = np.array([t[0] for t in tris], np.float32)
    tv1 = np.array([t[1] for t in tris], np.float32)
    tv2 = np.array([t[2] for t in tris], np.float32)
    tmat = np.array([t[3] for t in tris], np.int32)

    m_arr = np.zeros((len(mats), 14), np.float32)
    m_type = np.zeros(len(mats), np.int32)
    for i, (mt, alb, spec, rough, refidx, refr) in enumerate(mats):
        m_type[i] = mt
        m_arr[i, 0:3] = alb
        m_arr[i, 3:6] = spec
        m_arr[i, 6] = rough
        m_arr[i, 7] = refidx
        m_arr[i, 8:11] = refr

    lights = np.array([[-10, 15, 0], [8, 15, 3], [1, 15, -9]], np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PTScene(
        sp_center0=t(_pad(sp, 8)),
        sp_center1=t(_pad(sp1, 8)),
        sp_radius=t(_pad(rad, 8)),  # radius 0 never hits
        sp_time0=t(_pad(st0, 8)),
        sp_time1=t(_pad(st1, 8)),
        sp_mat=t(_pad(smat, 8).astype(np.int32)),
        tri_v0=t(_pad(tv0, 8)),
        tri_e1=t(_pad(tv1 - tv0, 8)),
        tri_e2=t(_pad(tv2 - tv0, 8)),
        tri_mat=t(_pad(tmat, 8).astype(np.int32)),
        materials=PTMaterials(
            mtype=t(m_type),
            albedo=t(m_arr[:, 0:3]),
            spec_color=t(m_arr[:, 3:6]),
            roughness=t(m_arr[:, 6]),
            ref_idx=t(m_arr[:, 7]),
            refract_color=t(m_arr[:, 8:11]),
            emissive=t(m_arr[:, 11:14]),
        ),
        light_pos=t(lights),
        light_color=t(np.ones((3, 3), np.float32)),
    )


def glsl_camera(res_x: int = 256, res_y: int = 256,
                mouse=(0.0, 0.0), showcase_dof: bool = False,
                orbit: bool = False, *, device) -> Camera:
    """mainImage camera setup (P3D_RT.glsl:293-341), both mouse modes.

    ``orbit=False`` is the slide branch (camPos from mouse x/y directly);
    ``orbit=True`` is the ORBIT_CAMERA branch (P3D_RT.glsl:5, 296-316):
    mouse == (0,0) pins the eye at (0,0,-8), otherwise spherical angles
    angleX = -mx·5 (sensitivity), angleY = mix(0.01, π−0.01, mouse.y)
    place the eye on a radius-8 sphere around the target.
    """
    cam_target = np.array([0.0, 0.0, -1.0], np.float32)
    if orbit:
        if mouse[0] + mouse[1] == 0.0:
            cam_pos = [0.0, 0.0, -8.0]
        else:
            mx = mouse[0] * 2.0 - 1.0
            small, big = 0.01, np.pi - 0.01
            angle_x = -mx * 5.0
            angle_y = small + (big - small) * mouse[1]
            cam_pos = (np.array([
                np.sin(angle_x) * np.sin(angle_y) * 8.0,
                -np.cos(angle_y) * 8.0,
                np.cos(angle_x) * np.sin(angle_y) * 8.0,
            ], np.float32) + cam_target).tolist()
    else:
        mx = mouse[0] * 2.0 - 1.0
        cam_pos = [mx * 10.0, mouse[1] * 5.0, 8.0]
    aperture = 10.0 if showcase_dof else 0.0
    focus = 0.5 if showcase_dof else 1.0
    cam = build_camera(dict(
        eye=np.array(cam_pos, np.float32),
        at=np.array([0, 0, -1], np.float32),
        up=np.array([0, 1, 0], np.float32),
        fov=60.0,
        hither=0.01,
        res_x=res_x, res_y=res_y,
        aperture_ratio=aperture,
        focal_ratio=focus,
    ), device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    return dataclasses.replace(cam, time0=one * 0.0, time1=one)
