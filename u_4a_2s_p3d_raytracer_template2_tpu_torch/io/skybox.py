"""Skybox cubemap loading (reference: Scene::LoadSkybox, scene.cpp:333-381);
the counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/io/skybox.py``.

Loads the six faces right, left, top, bottom, front, back as raw u8 with
the lower-left origin (DevIL's IL_ORIGIN_LOWER_LEFT) into one
``[6, H, W, 3]`` array. Pillow decodes the faces where it is installed, as
in the JAX package; without it PNG faces are decoded with ``zlib``
(``io/image.decode_png``), and a JPEG face, or faces of differing sizes
(which need Pillow's resize), give ``None``: the JAX package's answer when
it has no decoder.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .image import decode_png, save_png

FACES = ("right", "left", "top", "bottom", "front", "back")
_EXTS = (".jpg", ".jpeg", ".png")


def _face_path(sky_dir: str, face: str) -> Optional[str]:
    for ext in _EXTS:
        cand = os.path.join(sky_dir, face + ext)
        if os.path.exists(cand):
            return cand
    return None


def load_skybox_dir(sky_dir: str) -> Optional[np.ndarray]:
    """Return ``[6, H, W, 3]`` uint8, or None if the directory or a face is
    missing or cannot be decoded here.

    Raw bytes, as the reference keeps them; lookups convert a texel to float
    as u8/255.99 after the gather (``ops/shade.skybox_color``). The reference
    exits on a missing face (scene.cpp:358); like the JAX package, the port
    degrades to no skybox so that scenes such as balls_box.p3f (whose ``env
    skybox1`` directory does not exist) still load.
    """
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if not os.path.isdir(sky_dir):
        return None
    paths = [_face_path(sky_dir, face) for face in FACES]
    if any(p is None for p in paths):
        return None
    if Image is None and any(not p.endswith(".png") for p in paths):
        return None

    imgs = []
    for path in paths:
        if Image is not None:
            arr = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        else:
            arr = decode_png(path)
        imgs.append(arr[::-1])  # flip to the lower-left origin

    size = max(max(a.shape[0], a.shape[1]) for a in imgs)
    if Image is None and any(a.shape[:2] != (size, size) for a in imgs):
        return None
    out = np.zeros((6, size, size, 3), np.uint8)
    for i, a in enumerate(imgs):
        if a.shape[0] != size or a.shape[1] != size:
            im = Image.fromarray(a[::-1]).resize((size, size))
            a = np.asarray(im, np.uint8)[::-1]
        out[i] = a
    return out


def save_skybox_dir(sky_dir: str, faces) -> None:
    """Write a ``[6, H, W, 3]`` u8 cubemap (lower-left origin, as
    ``load_skybox_dir`` returns it) as six PNG faces into ``sky_dir``."""
    faces = np.asarray(faces)
    if faces.dtype != np.uint8 or faces.ndim != 4 or faces.shape[0] != 6:
        raise ValueError(f"want [6, H, W, 3] uint8 faces, got "
                         f"{faces.dtype} {faces.shape}")
    os.makedirs(sky_dir, exist_ok=True)
    for face, img in zip(FACES, faces):
        save_png(os.path.join(sky_dir, face + ".png"), img)
