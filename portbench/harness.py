"""What every cell's run shares: finding the cell, its configuration, its
traffic mix and its metric readers by the names in ``BENCHMARK.json``;
what a driver hands back (``Window``, ``Outcome``); the result's line; the
guard against the JAX package.

A traffic file names its ``kind``; the driver of that kind is the module
``portbench.drivers.<kind>``. A metric ``<name>`` is read by
``portbench/metrics/<name>.py``, whose ``read(outcome)`` returns a number,
or None where the run has nothing for it to read. So a later cell, mix or
metric is a new file and a new entry, and no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
PROGRAM = "u_4a_2s_p3d_raytracer_template2_tpu_torch"
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "u_4a_2s_p3d_raytracer_template2_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # BENCHMARK.json's metric entries that apply
    per_layer: list


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (PKG / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(name: str) -> Callable:
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Window:
    """The measured window: ``unit`` "frame" or "step"; per unit its
    latency (issue to result on the host) and its host time inside the
    entry call; the window's wall time; set-up time; the device's peak."""
    unit: str
    count: int
    wall_s: float
    latency_s: list
    host_s: list
    setup_s: float
    peak_bytes: int


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the window, the traced window (``--trace
    1``), the work bounds of the traced units by kind (``work(kind)`` ms,
    None where the cell has no such kernel), the comparison's numbers with
    their limits, attempted and failed units, the device record."""
    window: Window
    config: dict
    traffic: dict
    checks: dict                      # name -> (value, limit)
    attempted: int
    failed: int
    device: dict
    trace: object = None
    work: Callable[[str], Optional[float]] = lambda kind: None

    @property
    def correct(self) -> bool:
        return all(v is not None and math.isfinite(v) and v <= lim
                   for v, lim in self.checks.values())


def device_record(device, count: int, peak_bytes: int, trace=None) -> dict:
    """The result's ``device``: the card's name, the cards used, the peak
    of the fullest, and with a traced window its busy and window seconds."""
    on_card = device.type == "cuda"
    import torch

    rec = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        rec.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return rec


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def fifths(latency_s) -> str:
    """The window's mean latency, ms, in each fifth of its units: whether
    it drifts (printed on standard error, read by nothing)."""
    n = len(latency_s)
    parts = [latency_s[i * n // 5:(i + 1) * n // 5] for i in range(5)]
    return " ".join(f"{1e3 * sum(p) / len(p):.4f}" for p in parts if p)


def forbidden_loaded() -> list:
    """The forbidden top-level names among the loaded modules."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def result_line(cell: Cell, out: Outcome, trace: bool) -> dict:
    """The result's JSON object: the cell's end-to-end metrics, or with
    ``trace`` its per-layer metrics, each read by its own reader."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(out)
        if value is None:
            if not trace:
                raise RuntimeError(f"{cell.name}: no reading for the "
                                   f"end-to-end metric {m['name']}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": out.device}
    if trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line
