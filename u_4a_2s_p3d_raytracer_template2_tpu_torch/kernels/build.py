"""Build the CUDA sources under ``csrc/`` at first use and load them with
ctypes.

Each ``csrc/<name>.cu`` has a plain C interface, so it compiles with nvcc
alone, in seconds, into ``build/kernels/lib<name>_<hash>.so`` at the root of
the checkout. The hash covers the source, the headers beside it
(``csrc/*.cuh``) and the flags, so a stale library is never loaded. nvcc's resource report (``-Xptxas -v``: registers, spills,
shared memory) is kept beside the library as ``.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# f32 throughout: no fast math (nvcc's default IEEE division and sqrt).
# Multiply-add contraction stays on (nvcc's default) for the path tracer.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Sources built without contraction. The Whitted kernel picks a skybox
# texel by truncating a face coordinate: contracted, its directions round
# otherwise than the plain version's, and on mount_low 512x512, spp 4,
# depth 4 with a 2048x2048 noisy cubemap 2.63% of pixels differed by more
# than 2e-3 (mean 7.4e-5); uncontracted 0.012% (mean 3.3e-7), at 3.5-3.7%
# more kernel time (0.162-0.165 against 0.156-0.159 ms a launch, 6
# alternating pairs in each of three calls; chip_faults.py on an H100 80GB
# HBM3, 700 W, which requires the frame's limit to reject the contracted
# build). The BVH walk
# answers which primitive a ray hits, not a color: contracted, its sphere tests
# took another primitive than the plain version's on 43 of 262,144
# silhouette rays (0.016%) of the 7,396-sphere field at 512x512 (H100 80GB
# HBM3, 700 W); uncontracted, its f32 operations are the plain version's,
# one for one. Its slab tests have
# no multiply-add to contract. The brute-force kernels answer the same
# question with the same sphere and triangle tests, and are built the same
# way for the same reason. The device probes measure what the card retires
# under those flags, and their chains then round as their plain versions do
# except where they call fmaf.
NO_CONTRACTION = ("whitted_megakernel", "bvh_walk", "brute_intersect",
                  "probes")


def flags(name: str) -> tuple[str, ...]:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + (("--fmad=false",) if name in NO_CONTRACTION else ())


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + "\0".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    library's path. Raises with nvcc's output if the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build_log(name: str) -> str:
    """nvcc's output for the built library (ptxas registers and spills)."""
    return library_path(name).with_suffix(".log").read_text()


@functools.cache
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
