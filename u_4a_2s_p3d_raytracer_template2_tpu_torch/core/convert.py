"""The one crossing point between the JAX package and the port.

``scene_from_arrays`` turns the leaves of a JAX ``Scene``, read out as NumPy
arrays by the caller, into the port's ``Scene``. This module never imports
jax: the caller does the ``np.asarray``.

``arrays`` is keyed by dotted field path (``"prims.tri_p"``,
``"materials.kd"``, ``"lights.position"``, ``"camera.eye"``, ``"bg_color"``,
and ``"skybox"``, the ``[6, H, W, 3]`` cubemap, when ``has_skybox``);
``meta`` holds the static fields (``n_tri`` ... ``n_box``, ``res_x``,
``res_y``, ``accel_type``, ``spp``, ``n_objects``, ``n_lights``,
``has_reflective``, ``has_transmissive``, ``has_skybox``). Keys the port has
no field for (the accelerator tables, ``tri_mo``, ``sph_k``) are ignored: a
BVH or grid scene gets the port's own BVH tables, rebuilt from its
primitives, and every scene the brute-force kernels' tables.

``pt_scene_from_arrays`` does the same for the path tracer's ``PTScene``:
its leaves keyed by field name (``"sp_center0"``, ``"tri_mat"``,
``"light_pos"``) and ``"materials.<field>"`` for the materials.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as C
from ..accel.packets import build_packets
from ..models.pathtracer import PTMaterials, PTScene
from ..ops.intersect import brute_tables
from .types import Camera, Lights, Materials, Primitives, Scene


def _fields(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls)]


def scene_from_arrays(arrays: dict[str, np.ndarray], meta: dict,
                      device) -> Scene:
    def group(name, cls, static=()):
        kw = {}
        for f in _fields(cls):
            if f in static:
                kw[f] = int(meta[f])
            else:
                # np.array copies into a C-ordered array and keeps 0-d
                # scalars 0-d (np.ascontiguousarray would make them 1-d)
                kw[f] = torch.from_numpy(np.array(arrays[f"{name}.{f}"])
                                         ).to(device)
        return cls(**kw)

    n_obj = int(meta["n_objects"])
    packets = None
    if int(meta["accel_type"]) in (C.ACCEL_BVH, C.ACCEL_GRID) and n_obj > 0:
        packets = build_packets(np.asarray(arrays["prims.params"])[:n_obj],
                                np.asarray(arrays["prims.ptype"])[:n_obj],
                                device=device)
    prims = group("prims", Primitives, ("n_tri", "n_sph", "n_pl", "n_box"))
    # the cubemap keeps its dtype: u8 as loaded, f32 as a test gives it
    skybox = (torch.from_numpy(np.array(arrays["skybox"])).to(device)
              if meta.get("has_skybox") else None)
    return Scene(
        prims=prims,
        materials=group("materials", Materials),
        lights=group("lights", Lights),
        camera=group("camera", Camera, ("res_x", "res_y")),
        bg_color=torch.from_numpy(np.array(arrays["bg_color"])).to(device),
        skybox=skybox,
        has_skybox=skybox is not None,
        accel_type=int(meta["accel_type"]),
        spp=int(meta["spp"]),
        n_objects=int(meta["n_objects"]),
        n_lights=int(meta["n_lights"]),
        has_reflective=bool(meta["has_reflective"]),
        has_transmissive=bool(meta["has_transmissive"]),
        packets=packets,
        brute=brute_tables(prims),
    )


def pt_scene_from_arrays(arrays: dict[str, np.ndarray], device) -> PTScene:
    def t(key):
        return torch.from_numpy(np.array(arrays[key])).to(device)

    mats = PTMaterials(**{f: t(f"materials.{f}")
                          for f in _fields(PTMaterials)})
    return PTScene(materials=mats, **{
        f.name: t(f.name) for f in dataclasses.fields(PTScene)
        if f.init and f.name != "materials"})
