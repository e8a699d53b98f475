"""Image output (reference: saveImgFile via DevIL, main.cpp:261-276); the
counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/io/image.py``.

The renderer produces float images with row 0 = bottom scanline (the
reference's framebuffer convention); PNG rows run top-down, so ``save_png``
flips. The PNG is written with ``zlib`` and ``struct`` from the standard
library because the machines the port runs on need not have Pillow.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def u8_from_float(x) -> np.ndarray:
    """u8fromfloat (maths.h:113-117): x*255.99, saturated at 255."""
    v = np.asarray(x, np.float32) * 255.99
    return np.clip(v, 0.0, 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def save_png(path: str, image) -> None:
    """image: [H, W, 3] float in [0,1] or uint8 (NumPy array or tensor on
    any device), row 0 = bottom. Writes an 8-bit RGB PNG."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = u8_from_float(arr)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"want an [H, W, 3] image, got {arr.shape}")
    h, w, _ = arr.shape
    rows = np.ascontiguousarray(arr[::-1]).reshape(h, w * 3)
    # filter type 0 (None) before each scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
