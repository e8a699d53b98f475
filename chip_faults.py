"""Planted faults in the port's kernels, held to chip_smoke.py's limits.

    python3 chip_faults.py       # from the root of a checkout; needs one card

Builds copies of csrc/pt_megakernel.cu, csrc/bvh_walk.cu,
csrc/brute_intersect.cu and csrc/probes.cu (with the headers they include)
with one fault planted in each (under build/faults/, one nvcc per copy, all
started together), and runs the sound kernels and every faulty one through
chip_smoke.py's cases against the plain versions on the same inputs:
  * the path tracer's (chip_smoke.pt_cases), printing the share of pixels
    beyond 2e-3 and the mean and max abs difference of each, and whether
    the case's limits (chip_smoke.PT_LIMITS) reject it;
  * the BVH walk's (chip_smoke.bvh_cases), printing the share of rays whose
    closest-hit ids differ, the largest relative t difference and the share
    of occlusion results that differ, and whether chip_smoke.BVH_LIMITS
    reject it;
  * the brute-force kernels' (chip_smoke.brute_cases) with the same
    readings, judged by chip_smoke.BRUTE_LIMITS;
  * the device probes' checks of chip_smoke.py's phase 15: T3's walks of
    tools/probe_features.walk_cases against the oracle, exactly, in both
    stack placements, and T1's cheap class against its plain version
    (tools/roofline_mount.RTOL) and under 1.05 x its class ceiling.
Exits non-zero if a limit rejects a sound kernel or no case rejects a faulty
one.
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
PT_FAULTS = (
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


# (name, text of csrc/bvh_walk.cu, its faulty replacement)
BVH_FAULTS = (
    ("slab test without the safe inverse",
     "r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);",
     "r.ix = 1.f / r.dx; r.iy = 1.f / r.dy; r.iz = 1.f / r.dz;"),
    ("leaf loop skips its last primitive",
     "for (int i = m.x; i < m.x + m.y; ++i) {",
     "for (int i = m.x; i < m.x + m.y - 1; ++i) {"),
    ("any hit ignores max_t",
     "if (row_t<COUNT>(T.rows, i, r, rank, id, w) < max_t) return true;",
     "if (row_t<COUNT>(T.rows, i, r, rank, id, w) < kBig) return true;"),
)


# (name, text of csrc/brute_intersect.cu or of the tests it shares with the
# walk, csrc/prim_tests.cuh, and its faulty replacement)
BRUTE_FAULTS = (
    ("tie rule keeps the higher id",
     "(rank == brank && id < bid)", "(rank == brank && id > bid)"),
    ("tile loop drops the last partial tile",
     "return (n + tile - 1) / tile;", "return n / tile;"),
    ("any hit ignores max_t",
     "return t < max_t;", "return t < kBig;"),
    ("sphere test always takes the larger root",
     "float t = lo < 0.f ? hi : lo;", "float t = hi;"),
)


# (name, text of csrc/probes.cu, its faulty replacement)
PROBE_FAULTS = (
    ("T3 stack keeps one entry",
     "return sp;  // one slot per entry", "return 0;  // one slot per entry"),
    ("T1 cheap chain idempotent",
     "if (OP == kCheap) return fabsf(acc - x);",
     "if (OP == kCheap) return fmaxf(acc, x);"),
)


def build_fault(source, index, old, new):
    """Compile csrc/<source>.cu with ``old`` replaced by ``new``, in the
    source or in a header it includes (csrc/*.cuh): copies of both in a
    directory of the fault's own, so the copy's includes find the faulty
    header first."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.kernels import build as kb

    files = [kb.CSRC / f"{source}.cu", *sorted(kb.CSRC.glob("*.cuh"))]
    texts = {f.name: f.read_text() for f in files}
    where = [name for name, text in texts.items() if old in text]
    if len(where) != 1 or texts[where[0]].count(old) != 1:
        raise AssertionError(f"{source} fault {index}: {old!r} is not in the "
                             "source and its headers exactly once")
    texts[where[0]] = texts[where[0]].replace(old, new)
    out_dir = ROOT / "build" / "faults" / f"{source}_fault{index}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (out_dir / name).write_text(text)
    lib = out_dir / f"lib{source}_fault{index}.so"
    subprocess.run([kb.nvcc(), *kb.flags(source), "-o", str(lib),
                    str(out_dir / f"{source}.cu")],
                   check=True, capture_output=True, text=True)
    return lib


def entry_of(lib, name, like):
    """``name`` of the library ``lib`` with the C types of ``like``."""
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.restype, fn.argtypes = like.restype, like.argtypes
    return fn


def pt_verdicts(dev, kernels, sound, faulty):
    """Names of the path-tracer kernels the limits judge wrongly."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        pt_megakernel as ptk,
    )

    cases = list(chip_smoke.pt_cases(dev))
    wants = [ptk.trace_rays_plain(tables, *args, cfg)
             for _, _, tables, args, cfg in cases]
    failed = []
    for name, lib in [("sound", None)] + faulty:
        entry = sound if lib is None else entry_of(
            lib, "pt_megakernel_launch", sound)
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
    return failed


def bvh_verdicts(dev, kernels, sound, faulty):
    """Names of the BVH walk's kernels the limits judge wrongly."""
    cases = list(chip_smoke.bvh_cases(dev))
    wants = [chip_smoke.bvh_run(query, tables, args, kernel=False)
             for _, tables, query, args in cases]
    failed = []
    for name, lib in [("sound", None)] + faulty:
        entries = {n: sound[n] if lib is None else entry_of(lib, n, sound[n])
                   for n in sound}
        kernels._bvh_entry = lambda n, entries=entries: entries[n]
        rejected = 0
        for (label, tables, query, args), want in zip(cases, wants):
            reading = chip_smoke.hit_agreement(
                query, chip_smoke.bvh_run(query, tables, args), want)
            out = chip_smoke.rejects(reading, chip_smoke.BVH_LIMITS)
            rejected += bool(out)
            print(f"{name} | {label} ({query}): " + ", ".join(
                f"{k} {v:.3g}" for k, v in reading.items())
                + f"; {'rejected by ' + ', '.join(out) if out else 'passed'}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    return failed


def brute_verdicts(dev, kernels, sound, faulty):
    """Names of the brute-force kernels the limits judge wrongly."""
    cases = list(chip_smoke.brute_cases(dev))
    wants = [chip_smoke.brute_plain(query, prims, args)
             for _, prims, _, query, args in cases]
    failed = []
    for name, lib in [("sound", None)] + faulty:
        entries = {n: sound[n] if lib is None else entry_of(lib, n, sound[n])
                   for n in sound}
        kernels._brute_entry = lambda n, entries=entries: entries[n]
        rejected = 0
        for (label, _, tables, query, args), want in zip(cases, wants):
            reading = chip_smoke.hit_agreement(
                query, chip_smoke.brute_run(query, tables, args), want)
            out = chip_smoke.rejects(reading, chip_smoke.BRUTE_LIMITS)
            rejected += bool(out)
            print(f"{name} | {label} ({query}): " + ", ".join(
                f"{k} {v:.3g}" for k, v in reading.items())
                + f"; {'rejected by ' + ', '.join(out) if out else 'passed'}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    return failed


def probe_verdicts(dev, kernels, sound, faulty):
    """Names of the probe kernels that phase 15's checks judge wrongly:
    each must pass the sound library and reject its fault (T3 on the deep
    tree, T1's cheap class by its plain version or its ceiling)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        probe_features as pf,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        roofline_mount as rm,
    )

    failed = []
    for name, lib in [("sound", None)] + faulty:
        entries = {n: sound[n] if lib is None else entry_of(lib, n, sound[n])
                   for n in sound}
        kernels._probe_entry = lambda n, entries=entries: entries[n]
        verdicts = []
        try:
            pf.check_walks(dev, pf.FIELD_DEPTH)
            verdicts.append("walk passed")
        except AssertionError as e:
            verdicts.append(f"walk rejected ({e})")
        try:
            rm.part_rates(dev, ops=("cheap",))
            verdicts.append("rates passed")
        except AssertionError as e:
            verdicts.append(f"rates rejected ({e})")
        rejected = sum("rejected" in v for v in verdicts)
        print(f"{name} | probes: {'; '.join(verdicts)}")
        if (name == "sound") == (rejected > 0):
            failed.append(name)
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_faults: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    jobs = ([("pt_megakernel", i, f) for i, f in enumerate(PT_FAULTS)]
            + [("bvh_walk", i, f) for i, f in enumerate(BVH_FAULTS)]
            + [("brute_intersect", i, f) for i, f in enumerate(BRUTE_FAULTS)]
            + [("probes", i, f) for i, f in enumerate(PROBE_FAULTS)])
    bvh_names = ("bvh_closest_launch", "bvh_any_launch")
    brute_names = ("brute_closest_launch", "brute_any_launch")
    probe_names = ("op_rate_launch", "fma_peak_launch", "stack_walk_launch")
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 4) as pool:
        pt_sound = pool.submit(kernels._pt_entry)
        bvh_sound = pool.submit(lambda: {n: kernels._bvh_entry(n)
                                         for n in bvh_names})
        brute_sound = pool.submit(lambda: {n: kernels._brute_entry(n)
                                           for n in brute_names})
        probe_sound = pool.submit(lambda: {n: kernels._probe_entry(n)
                                           for n in probe_names})
        libs = list(pool.map(lambda j: build_fault(j[0], j[1], *j[2][1:]),
                             jobs))
    faulty = {src: [(f[0], lib) for (s, _, f), lib in zip(jobs, libs)
                    if s == src]
              for src in ("pt_megakernel", "bvh_walk", "brute_intersect",
                          "probes")}
    failed = (pt_verdicts(dev, kernels, pt_sound.result(),
                          faulty["pt_megakernel"])
              + bvh_verdicts(dev, kernels, bvh_sound.result(),
                             faulty["bvh_walk"])
              + brute_verdicts(dev, kernels, brute_sound.result(),
                               faulty["brute_intersect"])
              + probe_verdicts(dev, kernels, probe_sound.result(),
                               faulty["probes"]))
    print(f"chip_faults ({card}): " + (
        "the limits pass the sound kernels and reject every fault"
        if not failed else f"wrong verdict for: {', '.join(failed)}"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
