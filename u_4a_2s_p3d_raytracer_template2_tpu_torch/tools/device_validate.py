"""T2 on the card: the f32 FMA ceiling that a plain stream reaches, and the
per-class instruction ceilings; the counterpart of the ``vpu_peak`` section
and the roofline convention of tools/device_validate.py.

The JAX tool's other sections are not repeated here: chip_smoke.py's phases
3-14 hold every ported kernel (spheres K4, the Whitted megakernel K1/K2,
the path tracer K3, the packet walk K5) to its plain version beside its
bound. Its distribution-mode and grid sections wait for ROADMAP.md queue 1
items 7 and 9; its dragon and mount_high rows wait for their .p3f files.

Bounds keep the datasheet peaks (chip_smoke.PEAK_F32_FLOPS, 67 TFLOP/s at
700 W); what T2 measures stands beside them as what a plain FMA stream
reaches at the clock the card holds.

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.device_validate \\
        [peak|sass|all] [--device cpu]
"""
from __future__ import annotations

import argparse
import re
import subprocess
from collections import Counter

import torch

ROWS, LANE, N_FMA = 256, 128, 512     # the JAX tool's block and chain
# blocks a launch: the JAX tool's 64, grown 32x so that one launch runs
# about a millisecond on an H100 (2^26 elements, 68.7 GFLOP)
GRID = 2048
FLOP_PER_ELEMENT = 2 * N_FMA
DATASHEET_TFLOPS = 67.0   # H100 SXM f32 outside the tensor cores, 700 W
# kernel against plain version, largest |got - want| / max(|want|, 1): fmaf
# rounds once where the plain version rounds the product and the sum; a
# NumPy emulation of the JAX tool's 2,097,152 elements reads 2.8e-6
RTOL = 3e-5

# Instructions per clock per SM, compute capability 9.0, from the CUDA C++
# Programming Guide's table "Throughput of Native Arithmetic Instructions":
# "32-bit floating-point add, multiply, multiply-add" 128; "32-bit
# floating-point reciprocal, reciprocal square root, base-2 logarithm,
# base 2 exponential, sine, cosine" 16 (the MUFU unit). A class's ceiling is
# the rate of the one instruction its step cannot do without: an FFMA
# (fma), an FADD with an abs modifier (cheap), the MUFU reciprocal of IEEE
# division (div), MUFU.RSQ (rsqrt), the add or subtract a select picks
# (select). A measured rate above it means a folded chain or a wrong count.
PER_SM_PER_CLOCK = {"fma": 128, "cheap": 128, "div": 16, "rsqrt": 16,
                    "select": 128}


def card_info() -> dict:
    """nvidia-smi's name, power limit, SM clock and maximum SM clock of
    card 0."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power, sm, max_sm = (f.strip() for f in line.split(","))
    return {"name": name, "power_limit": power, "clocks_sm": sm,
            "clocks_max_sm": max_sm,
            "max_sm_hz": float(re.match(r"[\d.]+", max_sm).group()) * 1e6}


def class_ceiling(op: str, device=None) -> float:
    """Chain steps/s of the class ``op`` if every SM retired its limiting
    instruction (PER_SM_PER_CLOCK) at the maximum SM clock."""
    sms = torch.cuda.get_device_properties(
        torch.device(device or "cuda")).multi_processor_count
    return PER_SM_PER_CLOCK[op] * sms * card_info()["max_sm_hz"]


def fma_peak_input(grid: int, device) -> torch.Tensor:
    """The JAX tool's input: linspace(0.9, 1.1) over [grid·256, 128]."""
    return torch.linspace(0.9, 1.1, grid * ROWS * LANE, dtype=torch.float32,
                          device=device).reshape(grid * ROWS, LANE)


def fma_peak_plain(x) -> torch.Tensor:
    """The plain version of ``kernels.fma_peak``: tools/device_validate.py
    :120-135 one PyTorch op at a time."""
    a = x
    b = a * 1.0000001 + 0.3
    c = a * 0.9999999 - 0.2
    d = a + 0.1
    e = a - 0.1
    for _ in range(N_FMA // 8):
        b = b * a + 0.25
        c = c * a - 0.25
        d = d * a + 0.5
        e = e * a - 0.5
        b = b * 1.0000001 + c
        c = c * 0.9999998 + d
        d = d * 1.0000002 + e
        e = e * 0.9999997 + b
    return b + c + d + e


def clock_under_load(fn, args, ms: float, seconds: float = 0.5) -> dict:
    """card_info() read while about ``seconds`` of ``fn(*args)`` calls (each
    about ``ms``) are queued on the card."""
    for _ in range(max(1, int(seconds * 1e3 / ms))):
        fn(*args)
    info = card_info()
    torch.cuda.synchronize()
    return info


def vpu_peak(device="cuda", grid: int = GRID) -> dict:
    """T2 on the card: {tflops, ms, plain_ms, err (rel_err), abs_err, share
    (of the datasheet's 67 TFLOP/s), ceiling (TFLOP/s at the maximum SM
    clock), and the card's name, power limit and SM clock read under
    load}. Raises if the kernel
    and its plain version differ beyond RTOL or the rate is over 1.05 times
    the FMA ceiling."""
    from .. import kernels
    from ..utils.timing import cuda_ms, queued_ms
    from .roofline_mount import rel_err

    x = fma_peak_input(grid, device)
    got, want = kernels.fma_peak(x), fma_peak_plain(x)
    err = rel_err(got, want)
    abs_err = float((got.double() - want.double()).abs().max())
    del got, want
    ms = queued_ms(kernels.fma_peak, [(x,)] * 3)
    plain_ms = cuda_ms(fma_peak_plain, [(x,)], warmup=1)
    flop = x.numel() * FLOP_PER_ELEMENT
    tflops = flop / (ms * 1e-3) / 1e12
    ceiling = 2 * class_ceiling("fma", device) / 1e12
    info = clock_under_load(kernels.fma_peak, (x,), ms)
    out = dict(tflops=tflops, ms=ms, plain_ms=plain_ms, err=err,
               abs_err=abs_err, share=tflops / DATASHEET_TFLOPS,
               ceiling=ceiling, flop=flop, **info)
    print(f"vpu_peak: {tflops:.3f} TFLOP/s f32 FMA "
          f"({100 * out['share']:.1f}% of {DATASHEET_TFLOPS:g}, "
          f"{100 * tflops / ceiling:.1f}% of {ceiling:.2f} at the "
          f"maximum SM clock); {ms:.4f} ms a launch of {x.numel()} elements; "
          f"plain {plain_ms:.3f} ms; err {err:.3g} (limit {RTOL}); "
          f"{info['name']}, {info['power_limit']}, SM clock "
          f"{info['clocks_sm']} under load (max {info['clocks_max_sm']})",
          flush=True)
    if not err <= RTOL:
        raise AssertionError(f"T2: kernel and plain version differ by "
                             f"{err:.3g} (limit {RTOL})")
    if tflops > 1.05 * ceiling:
        raise AssertionError(f"T2: {tflops:.4g} TFLOP/s is over 1.05 x the "
                             f"FMA ceiling {ceiling:.4g}")
    return out


def sass_counts() -> dict[str, Counter]:
    """Opcodes of each probe kernel in the built library (cuobjdump -sass
    of csrc/probes.cu), by kernel: the check that no chain was folded."""
    from ..kernels import build as kb

    cuobjdump = kb.nvcc().replace("nvcc", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(kb.build("probes"))],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name:
            out[name][m.group(1)] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("part", nargs="?", default="all",
                    choices=("peak", "sass", "all"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda":
        y = fma_peak_plain(fma_peak_input(1, device))
        print(f"plain version only (--device cpu), [{ROWS}, {LANE}]: finite "
              f"{bool(torch.isfinite(y).all())}, max {float(y.max()):.4g}; "
              "vpu_peak: not measured")
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "version only")
    if args.part in ("peak", "all"):
        vpu_peak(device)
    if args.part in ("sass", "all"):
        for name, counts in sass_counts().items():
            print(f"sass {name}: " + ", ".join(
                f"{op} {n}" for op, n in counts.most_common()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
