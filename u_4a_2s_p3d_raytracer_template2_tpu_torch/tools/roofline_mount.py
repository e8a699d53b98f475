"""An instruction-level floor for the mount_low Whitted render on the card,
the counterpart of tools/roofline_mount.py.

Two parts, and the floor they give together:

  mix    count the operations per ray of the port's plain Whitted path (the
         sweep ``render_tile`` of mount_scene at 512x512, depth 4) by
         class, with a dispatch mode that sees every aten op: FMA (mul, add,
         sub, addcmul), cheap (min, max, abs, neg, compares, where, logic,
         dtype conversions), transcendental (div, rsqrt, sqrt, pow, exp,
         log) and other; views, copies and fills are free, as layout ops are
         in the JAX count (tools/roofline_mount.py:45-62).
  rates  T1 on the card (csrc/probes.cu op_rate_launch): one dependent
         chain of K = 512 steps a element of each class, in G chain-steps/s,
         each checked against its plain version and under 1.05 times its
         class ceiling (tools/device_validate.class_ceiling).
  floor  the JAX tool's mix-weighted instruction floor (tools/roofline_mount.py
         :204-210): fma/rate_fma + (cheap + other)/rate_cheap +
         trans/rate_div, per ray, times the frame's rays.

The floor charges every closest-hit test in full, over every slot of the
sweep's levels: the JAX megakernel is straight-line masked code, so there
this is the kernel's own work, while the port's CUDA kernel ends tests early
and walks only live rays. It sits beside K1's measured time and its bound,
which stays chip_smoke.whitted_work's.

T1's input is uniform on [-0.5, 1.5] (the JAX tool's is ones): on negative
elements the cheap chain |acc - x| grows by |x| a step, where a chain that
nvcc collapsed to an idempotent form (max(acc, x)) stays at x, so such a
chain fails the plain-version check as well as the ceiling.

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.roofline_mount \\
        mix|rates|all [--device cpu]
"""
from __future__ import annotations

import argparse
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import PROBE_OPS as OPS

K = 512                 # chain steps, the JAX tool's
# elements a launch: 2^26, the JAX tool's 96 x 256 x 128 grown until the
# fastest class runs about a millisecond a launch on an H100
ELEMENTS = 1 << 26
# kernel against plain version, largest |got - want| / max(|want|, 1): fmaf
# rounds once where the plain version rounds the product and the sum (a
# NumPy emulation of 2^20 chains reads 1.4e-5); rsqrtf is an approximate
# instruction (2 ulp) in a contracting chain; the other classes are IEEE
# operations in the same order
RTOL = {"fma": 1e-4, "cheap": 1e-6, "div": 1e-6, "rsqrt": 1e-5,
        "select": 1e-6}

FMA = {"mul", "add", "sub", "rsub", "addcmul"}
CHEAP = {"minimum", "maximum", "min", "max", "amin", "amax", "clamp",
         "clamp_min", "clamp_max", "abs", "neg", "floor", "sign", "eq", "ne",
         "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
         "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
         "bitwise_not", "bitwise_xor", "_to_copy"}
TRANS = {"div", "rsqrt", "sqrt", "pow", "exp", "log", "reciprocal", "sin",
         "cos", "tan", "atan2"}
FREE = {"copy", "clone", "contiguous", "detach", "lift_fresh",
        "lift_fresh_copy", "expand", "alias", "empty", "empty_like",
        "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
        "full_like", "fill", "zero", "scalar_tensor", "new_empty",
        "new_zeros", "new_ones", "new_full", "_local_scalar_dense"}


def _elements(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (tuple, list)):
        return max((_elements(o) for o in out), default=0)
    return 0


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.startswith("_"):
            name = name[:-1]            # in-place forms count as their op
        if name == "_to_copy" and (kwargs or {}).get(
                "dtype", args[0].dtype) == args[0].dtype:
            return out                  # a copy or a move: free
        if not (func.is_view or name in FREE):
            self.counts[name] += _elements(out)
        return out


def count_ops(fn, *args, **kwargs):
    """(fn(*args, **kwargs), Counter of elements written by aten op name),
    the counterpart of JAX's count_ops (tools/roofline_mount.py:45)."""
    counter = _OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.counts


def classify(counts) -> dict[str, float]:
    """Counts by aten op name summed into the JAX tool's classes."""
    cls = {"fma_class": 0.0, "cheap_class": 0.0, "trans_class": 0.0,
           "other": 0.0}
    for name, v in counts.items():
        key = ("fma_class" if name in FMA else "cheap_class" if name in CHEAP
               else "trans_class" if name in TRANS else "other")
        cls[key] += v
    return cls


def part_mix(device, res: int = 512, depth: int = 4) -> dict[str, float]:
    """Per-ray operations by class of the sweep ``render_tile`` of
    mount_scene at ``res``², ``depth``."""
    from ..core.build import build_scene
    from ..core.types import RenderConfig
    from ..models.scenes import mount_scene
    from ..models.whitted import pixel_grid, render_tile

    scene = build_scene(mount_scene(res=res), device=device)
    px, py = pixel_grid(res, res, device)
    _, counts = count_ops(render_tile, scene, px, py,
                          RenderConfig(max_depth=depth))
    R = res * res
    cls = {k: v / R for k, v in classify(counts).items()}
    print(f"== mount_low sweep per-ray op mix ({res}x{res}, depth {depth}, "
          f"{torch.device(device).type})")
    for k, v in sorted(cls.items()):
        print(f"  {k:12s} {v:9.1f} ops/ray")
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
    print("  busiest ops:", {k: round(v / R, 1) for k, v in top})
    print(f"  TOTAL {sum(cls.values()):9.1f} ops/ray")
    return cls


def op_rate_input(n: int, device, seed: int = 0) -> torch.Tensor:
    """T1's input: ``n`` f32 uniform on [-0.5, 1.5] from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, generator=g, device=device) * 2.0 - 0.5


def op_rate_plain(x, op: str, k: int = K) -> torch.Tensor:
    """The plain version of ``kernels.op_rate``: the step bodies of
    tools/roofline_mount.py:148-163, one PyTorch op at a time."""
    a = x * 1e-9 + 0.9999
    acc = x
    for _ in range(k):
        if op == "fma":
            acc = acc * a + x
        elif op == "cheap":
            acc = (acc - x).abs()
        elif op == "div":
            acc = x / (acc + 1.5)
        elif op == "rsqrt":
            acc = torch.rsqrt(acc.abs() + 1.1)
        elif op == "select":
            acc = torch.where(acc > x, acc - x, acc + x)
        else:
            raise ValueError(f"op: want one of {OPS}, got {op!r}")
    return acc


def rel_err(got, want) -> float:
    """Largest |got - want| / max(|want|, 1); inf where got is not
    finite."""
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    d = (got.double() - want.double()).abs() / want.double().abs().clamp_min(1)
    return float(d.max())


def part_rates(device, n: int = ELEMENTS, k: int = K,
               ops=OPS) -> dict[str, dict]:
    """T1 on the card for the classes ``ops``: {op: {rate (chain steps/s), ms,
    plain_ms, err (rel_err), abs_err, ceiling, bound_ms (the launch's steps
    at the ceiling)}}. Raises if a class disagrees with its plain
    version beyond RTOL or runs over 1.05 times its class ceiling."""
    from .. import kernels
    from ..utils.timing import cuda_ms, queued_ms
    from .device_validate import class_ceiling

    x = op_rate_input(n, device)
    out = {}
    print(f"== T1 per-class rates ({n} elements x {k} dependent steps)")
    for op in ops:
        got, want = kernels.op_rate(x, op, k), op_rate_plain(x, op, k)
        err = rel_err(got, want)
        abs_err = float((got.double() - want.double()).abs().max())
        del got, want
        ms = queued_ms(kernels.op_rate, [(x, op, k)] * 3)
        plain_ms = cuda_ms(op_rate_plain, [(x, op, k)], warmup=1)
        rate = n * k / (ms * 1e-3)
        ceiling = class_ceiling(op, device)
        out[op] = dict(rate=rate, ms=ms, plain_ms=plain_ms, err=err,
                       abs_err=abs_err, ceiling=ceiling,
                       bound_ms=n * k / ceiling * 1e3)
        print(f"  {op:7s} {rate / 1e9:9.1f} G chain-steps/s ({ms:.4f} ms a "
              f"launch, {100 * rate / ceiling:.1f}% of the class ceiling "
              f"{ceiling / 1e9:.1f}); plain {plain_ms:.3f} ms; err {err:.3g} "
              f"(limit {RTOL[op]})", flush=True)
        if not err <= RTOL[op]:
            raise AssertionError(f"T1 {op}: kernel and plain version differ "
                                 f"by {err:.3g} (limit {RTOL[op]})")
        if rate > 1.05 * ceiling:
            raise AssertionError(f"T1 {op}: {rate:.4g} steps/s is over 1.05 "
                                 f"x the class ceiling {ceiling:.4g}: a "
                                 "folded chain or a wrong count")
    return out


def mix_floor(cls, rates, rays: int) -> float:
    """Seconds a frame of ``rays`` rays at the mix ``cls`` (ops per ray)
    takes at the class rates ``rates`` (chain steps/s by class), by the JAX
    tool's formula: FMA-class ops at the fma rate, cheap and other at the
    cheap rate, transcendental at the div rate."""
    return (cls["fma_class"] / rates["fma"]
            + (cls["cheap_class"] + cls["other"]) / rates["cheap"]
            + cls["trans_class"] / rates["div"]) * rays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("part", nargs="?", default="all",
                    choices=("mix", "rates", "all"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=512)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to count the mix "
                         "only")
    cls = rates = None
    if args.part in ("mix", "all"):
        cls = part_mix(device, args.res)
    if args.part in ("rates", "all"):
        if device.type != "cuda":
            print("rates: not measured (--device cpu; T1 runs on the card "
                  "only)")
        else:
            rates = {op: r["rate"] for op, r in part_rates(device).items()}
    if cls and rates:
        t = mix_floor(cls, rates, args.res ** 2)
        print(f"== mix-weighted instruction floor: {t * 1e3:.4f} ms/frame at "
              f"{args.res}x{args.res}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
