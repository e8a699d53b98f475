"""Planted faults in the path-tracer kernel, held to chip_smoke.py's limits.

    python3 chip_faults.py       # from the root of a checkout; needs one card

Builds copies of csrc/pt_megakernel.cu with one fault planted in each (under
build/faults/, one nvcc per copy, all started together), runs the sound
kernel and every faulty one through chip_smoke.py's path-tracer cases
(chip_smoke.pt_cases) against the plain version on the same rays and
uniforms, and prints, for each case, the share of pixels beyond 2e-3, the
mean and max abs difference, and whether the case's limits
(chip_smoke.PT_LIMITS) reject it. Exits non-zero if a limit rejects the
sound kernel or no case rejects a faulty one.
"""
import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke

ROOT = Path(__file__).resolve().parent

# (name, text of csrc/pt_megakernel.cu, its faulty replacement)
FAULTS = (
    ("no dielectric highlight",
     "mtype == kMetal ? albedo : v3(0.004f, 0.004f, 0.004f)",
     "mtype == kMetal ? albedo : v3(0.f, 0.f, 0.f)"),
    ("hollow shell not flipped",
     "* (p[6] < 0.f ? -1.f : 1.f)", "* 1.f"),
    ("no Beer's law",
     "atten = albedo * v3(expf(rc.x * -t), expf(rc.y * -t), "
     "expf(rc.z * -t));",
     "atten = albedo;"),
    ("metal fuzz renormalised",
     "new_d = mirror + rough * unit_sphere(u[3 * R], u[4 * R], u[5 * R]);",
     "new_d = normalize(mirror + rough * unit_sphere(u[3 * R], u[4 * R], "
     "u[5 * R]));"),
    ("triangle u+v guard",
     "if (!(v >= 0.f && v <= 1.f)) return kBig;",
     "if (!(v >= 0.f && u + v <= 1.f)) return kBig;"),
    ("feeler bound ignores len1",
     "shadow_len1 ? 1.f : len", "len"),
)


def build_fault(index, old, new):
    """Compile csrc/pt_megakernel.cu with ``old`` replaced by ``new``."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.kernels import build as kb

    src = (kb.CSRC / "pt_megakernel.cu").read_text()
    if src.count(old) != 1:
        raise AssertionError(f"fault {index}: {old!r} is not in the source "
                             "exactly once")
    out_dir = ROOT / "build" / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"pt_fault{index}.cu"
    cu.write_text(src.replace(old, new))
    lib = out_dir / f"libpt_fault{index}.so"
    subprocess.run([kb.nvcc(), *kb.NVCC_FLAGS, "-o", str(lib), str(cu)],
                   check=True, capture_output=True, text=True)
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_faults: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pt_megakernel as ptk,
    )

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    with concurrent.futures.ThreadPoolExecutor(len(FAULTS) + 1) as pool:
        sound = pool.submit(kernels._pt_entry)
        libs = list(pool.map(lambda f: build_fault(f[0], *f[1][1:]),
                             enumerate(FAULTS)))
    sound = sound.result()
    cases = list(chip_smoke.pt_cases(dev))
    wants = [ptk.trace_rays_plain(tables, *args, cfg)
             for _, _, tables, args, cfg in cases]

    failed = []
    for name, lib in [("sound", None)] + [(f[0], lib)
                                          for f, lib in zip(FAULTS, libs)]:
        entry = sound
        if lib is not None:
            entry = ctypes.CDLL(str(lib)).pt_megakernel_launch
            entry.restype, entry.argtypes = sound.restype, sound.argtypes
        kernels._pt_entry = lambda entry=entry: entry
        rejected = 0
        for (label, (max_bad, max_mean), tables, args, cfg), want in zip(
                cases, wants):
            got = kernels.pt_megakernel(tables, *args, cfg)
            bad, mean, err = chip_smoke.pt_agreement(got, want)
            out = (bad > max_bad or mean > max_mean
                   or not bool(torch.isfinite(got).all()))
            rejected += out
            print(f"{name} | {label}: {bad * 100:.4f}% pixels beyond "
                  f"{chip_smoke.ATOL}, mean abs diff {mean:.3g}, max abs diff "
                  f"{err:.3g}; limits {max_bad * 100}%, {max_mean}: "
                  f"{'rejected' if out else 'passed'}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    print(f"chip_faults ({card}): " + (
        "the limits pass the sound kernel and reject every fault"
        if not failed else f"wrong verdict for: {', '.join(failed)}"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
