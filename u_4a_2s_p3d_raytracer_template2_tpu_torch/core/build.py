"""SceneDef (host NumPy) -> Scene (tensors on one device, padded shapes).

The counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/core/build.py``
(``build_camera``, ``build_scene``): the tables are computed with the same
NumPy operations, so they equal the JAX build exactly. A BVH or grid scene
also gets the port's BVH tables (``accel/packets.build_packets``), built once
on the host and uploaded; a grid scene routes to the same walk, as the JAX
package does on the TPU. An ``env`` directory's cubemap is loaded as raw u8
(io/skybox.py). Every scene gets the brute-force kernels' tables
(``ops/intersect.brute_tables``), packed once on its device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import constants as C
from .types import Camera, Lights, Materials, Primitives, Scene


_PAD = 8  # table rows are padded to a multiple of 8, as in the JAX build


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def build_camera(cam: dict, *, device) -> Camera:
    """Derive the uvn frame exactly like the reference ctor (camera.h:35-73)."""
    eye = np.asarray(cam["eye"], np.float32)
    at = np.asarray(cam["at"], np.float32)
    up = np.asarray(cam["up"], np.float32)
    n = eye - at
    plane_dist = float(np.linalg.norm(n))
    n = n / plane_dist
    u = np.cross(up, n)
    u = u / np.linalg.norm(u)
    v = np.cross(n, u)
    h = 2.0 * plane_dist * math.tan(math.pi * cam["fov"] / 180.0 / 2.0)
    w = (cam["res_x"] / cam["res_y"]) * h
    # lens aperture = aperture_ratio * pixel size (camera.h:66)
    aperture = cam["aperture_ratio"] * (w / cam["res_x"])

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        eye=f32(eye), u=f32(u), v=f32(v), n=f32(n),
        w=f32(w), h=f32(h), plane_dist=f32(plane_dist),
        focal_ratio=f32(cam["focal_ratio"]), aperture=f32(aperture),
        time0=f32(0.0), time1=f32(0.0),
        res_x=int(cam["res_x"]), res_y=int(cam["res_y"]),
    )


def build_scene(sd, *, device, accel: Optional[int] = None) -> Scene:
    """Pad a SceneDef and upload it to ``device``; ``accel`` overrides the
    scene's accelerator (ACCEL_NONE, ACCEL_GRID or ACCEL_BVH).

    A scene with an ``env`` line loads its cubemap (io/skybox.py) as raw
    u8; when the directory, a face or a decoder is missing it builds with
    ``has_skybox=False``, as the JAX package's build does.
    """
    accel_type = sd.accel_type if accel is None else accel
    if sd.camera is None:
        raise ValueError("scene has no camera ('v' block)")

    n_obj = len(sd.objects)
    n_pad = _round_up(n_obj, _PAD)
    params = np.zeros((n_pad, 12), np.float32)
    ptype = np.full(n_pad, C.INVALID, np.int32)
    mat_id = np.zeros(n_pad, np.int32)
    for i, o in enumerate(sd.objects):
        params[i] = o.params
        ptype[i] = o.ptype
        mat_id[i] = max(o.mat_id, 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # type-grouped views (pre-gathered so the brute-force path is dense)
    def group(code, width):
        ids = np.nonzero(ptype[:n_obj] == code)[0].astype(np.int32)
        k = _round_up(max(len(ids), 1), _PAD)
        p = np.zeros((k, width), np.float32)
        gi = np.full(k, -1, np.int32)
        if len(ids):
            p[: len(ids)] = params[ids, :width]
            gi[: len(ids)] = ids
        return t(p), t(gi), len(ids)

    tri_p, tri_ids, n_tri = group(C.TRIANGLE, 12)
    sph_p, sph_ids, n_sph = group(C.SPHERE, 4)
    pl_p, pl_ids, n_pl = group(C.PLANE, 4)
    box_p, box_ids, n_box = group(C.AABOX, 6)

    n_mat = max(1, len(sd.materials))
    mats = np.zeros((n_mat, 11), np.float32)
    for i, m in enumerate(sd.materials):
        mats[i] = m
    materials = Materials(
        diff_color=t(mats[:, 0:3]), kd=t(mats[:, 3]),
        spec_color=t(mats[:, 4:7]), ks=t(mats[:, 7]), shine=t(mats[:, 8]),
        transmit=t(mats[:, 9]), ior=t(mats[:, 10]),
    )

    n_l = max(1, len(sd.lights))
    lt = np.zeros((n_l, 6), np.float32)
    for i, light in enumerate(sd.lights):
        lt[i] = light
    lights = Lights(position=t(lt[:, 0:3]), color=t(lt[:, 3:6]))

    packets = None
    if accel_type in (C.ACCEL_BVH, C.ACCEL_GRID) and n_obj > 0:
        from ..accel.packets import build_packets

        packets = build_packets(params[:n_obj], ptype[:n_obj], device=device)

    from ..ops.intersect import brute_tables

    prims = Primitives(
        params=t(params), ptype=t(ptype), mat_id=t(mat_id),
        tri_p=tri_p, tri_ids=tri_ids, sph_p=sph_p, sph_ids=sph_ids,
        pl_p=pl_p, pl_ids=pl_ids, box_p=box_p, box_ids=box_ids,
        n_tri=n_tri, n_sph=n_sph, n_pl=n_pl, n_box=n_box,
    )
    skybox = None
    if sd.skybox_dir is not None:
        from ..io.skybox import load_skybox_dir

        faces = load_skybox_dir(sd.skybox_dir)
        if faces is not None:
            skybox = t(faces)
    return Scene(
        prims=prims,
        materials=materials,
        lights=lights,
        camera=build_camera(sd.camera, device=device),
        bg_color=t(np.asarray(sd.bg_color, np.float32)),
        skybox=skybox,
        has_skybox=skybox is not None,
        accel_type=int(accel_type),
        spp=int(sd.spp),
        n_objects=n_obj,
        n_lights=len(sd.lights),
        has_reflective=bool((mats[:, 7] > 0).any()),
        has_transmissive=bool((mats[:, 9] != 0).any()),
        packets=packets,
        brute=brute_tables(prims),
    )
