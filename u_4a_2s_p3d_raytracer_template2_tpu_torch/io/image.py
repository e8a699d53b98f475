"""Image output (reference: saveImgFile via DevIL, main.cpp:261-276); the
counterpart of ``u_4a_2s_p3d_raytracer_template2_tpu/io/image.py``.

The renderer produces float images with row 0 = bottom scanline (the
reference's framebuffer convention); PNG rows run top-down, so ``save_png``
flips. PNGs are written and read with ``zlib``, ``struct`` and NumPy
because the machines the port runs on need not have Pillow: ``decode_png``
reads the 8-bit RGB and RGBA non-interlaced PNGs that the port, the
reference's tools and most editors write (filters 0-4).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def u8_from_float(x) -> np.ndarray:
    """u8fromfloat (maths.h:113-117): x*255.99, saturated at 255."""
    v = np.asarray(x, np.float32) * 255.99
    return np.clip(v, 0.0, 255.0).astype(np.uint8)


def float_from_u8(x) -> np.ndarray:
    """u8tofloat (maths.h:120-123)."""
    return np.asarray(x, np.float32) / 255.99


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


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9): [h, w*bpp] u8."""
    stride = w * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {data.size} bytes, want "
                         f"{h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    if not data[:, 0].any():  # filter 0 throughout, as save_png writes
        return data[:, 1:].copy()
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            # left neighbours feed back: one step per pixel, bpp lanes each
            # (slow on large images; Pillow decodes them where it exists)
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    pred = _paeth(a, b, c)
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = prev = cur
    return out.astype(np.uint8)


def decode_png(path: str) -> np.ndarray:
    """[H, W, 3] u8 of an 8-bit RGB or RGBA non-interlaced PNG, rows top
    down as stored (alpha dropped). Raises ValueError on anything else."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}; want 8-bit RGB or RGBA, "
                         "not interlaced")
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)
    return rows.reshape(h, w, channels)[:, :, :3]


def load_png(path: str) -> np.ndarray:
    """[H, W, 3] float in [0,1] (u8tofloat), row 0 = bottom: the inverse of
    ``save_png`` up to the u8 quantisation."""
    return float_from_u8(decode_png(path)[::-1])
