"""Run one cell of the port's benchmark and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
mix are found by name in ``BENCHMARK.json``; the traffic's ``kind`` picks
the driver (``portbench/drivers``). The run builds the scene, warms up
(set-up), drives the traffic for ``--seconds``, with ``--trace 1`` traces a
short window after it, checks what the window produced against the plain
reference, and prints the numbers compared with their limits on standard
error and one JSON object as the last line of standard output. Without a
CUDA card, or with fewer cards than the cell asks for, it exits 2 and
prints no result; with a module of JAX or of the JAX package loaded at the
end, it exits 3.

Options beside the benchmark's four: ``--calibrate SEEDS`` (after the set-up,
the comparison's readings on each of a comma-separated list of seeds, and
with ``--control`` the control's, one JSON line each), ``--device cpu``,
``--override JSON`` and ``--fault NAME`` (the tests' small CPU runs with a
planted fault), ``--rank``/``--ports`` (the ranks a cell of several cards
starts).
"""
import time

T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", default="")
    p.add_argument("--control", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--override", default="{}")
    p.add_argument("--fault", default="")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--ports", default="")
    return p.parse_args(argv)


def overridden(cell, override: dict):
    """The cell with ``override``'s "config" and "traffic" keys replaced,
    a dict merged key by key, and its "chips" (the tests' small sizes and
    ranks)."""
    cell.chips = int(override.get("chips", cell.chips))
    for part in ("config", "traffic"):
        target = getattr(cell, part)
        for key, value in override.get(part, {}).items():
            if isinstance(value, dict) and isinstance(target.get(key), dict):
                value = {**target[key], **value}
            target[key] = value
    return cell


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    cell = overridden(harness.load_cell(args.workload),
                      json.loads(args.override))
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    drv = harness.driver(cell.traffic["kind"])
    wrap = None
    if args.fault:
        from portbench.tests import faults

        wrap = faults.planted(args.fault)
    if args.rank > 0:
        return drv.rank_main(cell, args, wrap)
    if args.calibrate:
        seeds = [int(s) for s in args.calibrate.split(",")]
        for line in drv.calibrate(cell, args, seeds, wrap):
            print(json.dumps(line), flush=True)
        return 0
    out = drv.run(cell, args, T0, wrap)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: modules of {', '.join(bad)} are loaded",
              file=sys.stderr)
        return 3
    print(f"portbench: {out.window.count} {out.window.unit}s; ms a "
          f"{out.window.unit} in each fifth of the window: "
          f"{harness.fifths(out.window.latency_s)}", file=sys.stderr)
    line = harness.result_line(cell, out, bool(args.trace))
    for name, (value, limit) in out.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
