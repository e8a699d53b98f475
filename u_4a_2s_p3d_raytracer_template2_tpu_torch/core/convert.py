"""The one crossing point between the JAX package and the port.

``scene_from_arrays`` turns the leaves of a JAX ``Scene``, read out as NumPy
arrays by the caller, into the port's ``Scene``. This module never imports
jax: the caller does the ``np.asarray``.

``arrays`` is keyed by dotted field path (``"prims.tri_p"``,
``"materials.kd"``, ``"lights.position"``, ``"camera.eye"``, ``"bg_color"``);
``meta`` holds the static fields (``n_tri`` ... ``n_box``, ``res_x``,
``res_y``, ``accel_type``, ``spp``, ``n_objects``, ``n_lights``,
``has_reflective``, ``has_transmissive``, ``has_skybox``). Keys the port has
no field for (the accelerator tables, ``tri_mo``, ``sph_k``) are ignored.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as C
from .types import Camera, Lights, Materials, Primitives, Scene


def _fields(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls)]


def scene_from_arrays(arrays: dict[str, np.ndarray], meta: dict,
                      device) -> Scene:
    if int(meta["accel_type"]) != C.ACCEL_NONE:
        raise NotImplementedError(
            "accelerator tables are not ported yet (ROADMAP.md, queue 1, "
            "item 9 'Accelerators')")
    if meta.get("has_skybox"):
        raise NotImplementedError(
            "skybox scenes are not ported yet (ROADMAP.md, queue 1, item 7 "
            "'Distribution mode and skybox')")

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

    return Scene(
        prims=group("prims", Primitives, ("n_tri", "n_sph", "n_pl", "n_box")),
        materials=group("materials", Materials),
        lights=group("lights", Lights),
        camera=group("camera", Camera, ("res_x", "res_y")),
        bg_color=torch.from_numpy(np.array(arrays["bg_color"])).to(device),
        accel_type=int(meta["accel_type"]),
        spp=int(meta["spp"]),
        n_objects=int(meta["n_objects"]),
        n_lights=int(meta["n_lights"]),
        has_reflective=bool(meta["has_reflective"]),
        has_transmissive=bool(meta["has_transmissive"]),
    )
