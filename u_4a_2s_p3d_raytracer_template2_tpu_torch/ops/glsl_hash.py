"""NumPy replication of the GLSL template's uint-hash RNG
(common.glsl:31-59) — used host-side to regenerate the hardcoded procedural
sphere field of the GLSL path-tracer world (P3D_RT.glsl:88-178) bit-exactly.

A copy of ``u_4a_2s_p3d_raytracer_template2_tpu/ops/glsl_hash.py``. Device-side
sampling draws from explicit ``torch.Generator``s instead; this module exists
so the *scene* matches the reference exactly.
"""
from __future__ import annotations

import numpy as np

_M = np.uint32(1103515245)


def base_hash(px: np.uint32, py: np.uint32) -> np.uint32:
    """baseHash(uvec2) (common.glsl:31-36)."""
    with np.errstate(over="ignore"):
        px = np.uint32(px)
        py = np.uint32(py)
        qx = _M * ((px >> np.uint32(1)) ^ py)
        qy = _M * ((py >> np.uint32(1)) ^ px)
        h32 = _M * (qx ^ (qy >> np.uint32(3)))
        return np.uint32(h32 ^ (h32 >> np.uint32(16)))


def _float_bits(x: float) -> np.uint32:
    return np.frombuffer(np.float32(x).tobytes(), np.uint32)[0]


class SeedStream:
    """Mutable seed mimicking GLSL ``inout float seed`` with ``seed += 0.1``
    twice per call (left-to-right argument evaluation)."""

    def __init__(self, seed: float):
        self.seed = np.float32(seed)

    def _next_pair(self):
        a = np.float32(self.seed + np.float32(0.1))
        b = np.float32(a + np.float32(0.1))
        self.seed = b
        return _float_bits(a), _float_bits(b)

    def hash1(self) -> float:
        a, b = self._next_pair()
        n = base_hash(a, b)
        return float(n) / float(0xFFFFFFFF)

    def hash2(self) -> np.ndarray:
        a, b = self._next_pair()
        n = base_hash(a, b)
        with np.errstate(over="ignore"):
            rz = np.array([n, n * np.uint32(48271)], np.uint32)
        return (rz & np.uint32(0x7FFFFFFF)).astype(np.float64) / float(
            0x7FFFFFFF)

    def hash3(self) -> np.ndarray:
        a, b = self._next_pair()
        n = base_hash(a, b)
        with np.errstate(over="ignore"):
            rz = np.array(
                [n, n * np.uint32(16807), n * np.uint32(48271)], np.uint32)
        return (rz & np.uint32(0x7FFFFFFF)).astype(np.float64) / float(
            0x7FFFFFFF)
