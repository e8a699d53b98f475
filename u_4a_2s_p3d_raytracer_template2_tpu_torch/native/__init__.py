"""The host builders of the reference's accelerators in C++
(``native/src/accel_build.cpp``: ``rt_build_bvh``, ``rt_build_grid``) behind
a C ABI, loaded with ctypes; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/native/__init__.py``.

``g++`` builds the source at first use into ``build/native/`` at the root
of the checkout, as ``libaccel_build_<hash>.so`` where the hash covers the
source and the flags (``kernels/build.py`` builds the CUDA sources the same
way), so a stale library is never loaded and nothing is written beside the
source. The flags keep f32 arithmetic as written (no ``-march=native``, no
contraction), so the tables equal the NumPy builders' of accel/bvh.py and
accel/grid.py on any host. A machine without ``g++`` gets ``None`` from
``get_lib`` and the callers use those NumPy builders; a failed build
raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "accel_build.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + "\0".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libaccel_build_{digest[:16]}.so"


def build(compiler: str) -> Path:
    """Compile the source with ``compiler`` unless its library exists;
    return the library's path. Raises with the compiler's output if the
    build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed to build {SRC.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def get_lib():
    """The loaded library, or None on a machine without ``g++``."""
    compiler = shutil.which("g++")
    if compiler is None:
        return None
    lib = ctypes.CDLL(str(build(compiler)))
    c_int = ctypes.c_int
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rt_build_bvh.restype = c_int
    lib.rt_build_bvh.argtypes = [fp, fp, c_int, c_int, ip, fp, fp, u8p, ip,
                                 ip]
    lib.rt_build_grid.restype = c_int
    lib.rt_build_grid.argtypes = [fp, fp, c_int, ctypes.c_float, fp, fp, ip,
                                  c_int, ip, ip]
    return lib


def available() -> bool:
    return get_lib() is not None
