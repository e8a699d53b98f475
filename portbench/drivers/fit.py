"""The light fit: back-to-back inverse-rendering jobs (traffic kind
``fit``), as ``cli fit --fit lights`` runs one.

A job is ``job_steps`` compiled train steps of the program
(``parallel/dist.make_train_step(train_step_full, ...)``, lr ``lr``, only
the light positions' scale at 1) from the scene with its lights moved by an
offset drawn from (seed, job), towards the target, the scene's own render;
the loss is read on the host after every step, as ``cli fit`` prints it.
Set-up builds the step and runs the first ``check_steps`` steps of job 0
(the first capture among them); the window continues job 0 and starts a
job after another while less than ``--seconds`` have passed, so it ends
with a whole job. On a cell of more than one chip the job runs under
``torch.distributed`` on NCCL, one rank a card, each step one graph a rank
with its all-reduce inside; the ranks start each job together (a store the
harness keeps) and rank 0 reports.

The comparison: the plain reference follows the first ``check_steps``
steps of job 0 and of one window job drawn from the seed, from the same
start, with plain autograd. Numbers: the largest relative gap of a
checked step's loss, and the median of those gaps over the checked steps;
the relative gap of the first gradient's norm, the program's worked out
from its light positions after one step ((start - after) / lr), the
reference's from autograd; and of the norm of the lights' move after the
last checked step. Each is the worst over the jobs checked.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import random
import socket
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import scenes, trace, work
from ..harness import ROOT, Outcome, Window, device_record, sync
from ..reference import whitted as ref

CHECKS = ("loss_rel", "loss_med", "grad_rel", "move_rel")
STORE_TIMEOUT_S = 300.0
CHILD_GRACE_S = 180.0


def program():
    """The program's entry points this driver calls."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io import p3f
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    return SimpleNamespace(build_scene=build_scene, RenderConfig=RenderConfig,
                           p3f=p3f, dist=dist, graphs=graphs)


def job_offset(desc: scenes.Description, traffic: dict, seed: int,
               job: int) -> np.ndarray:
    """[L, 3] f32: light ``traffic["light"]`` moved ``offset_norm`` along a
    direction drawn from (seed, job), the other lights held."""
    rng = np.random.default_rng([abs(int(seed)), int(job)])
    v = rng.standard_normal(3)
    out = np.zeros((len(desc.lights), 3), np.float32)
    out[int(traffic["light"])] = (v / np.linalg.norm(v)
                                  * float(traffic["offset_norm"]))
    return out


@dataclasses.dataclass
class Record:
    """A checked job's start offset, its first steps' losses, and its light
    positions after the first step and after the last checked one."""
    job: int
    offset: np.ndarray
    losses: list = dataclasses.field(default_factory=list)
    after_first: torch.Tensor = None
    after_last: torch.Tensor = None


class Fitter:
    """The program side: the scene, its target and the compiled step."""

    def __init__(self, cell, device, wrap=None):
        self.p = program()
        if wrap is not None:
            wrap(self.p)
        self.device = device
        self.traffic = cell.traffic
        self.desc = scenes.describe(cell.config)
        sd = scenes.to_scene_def(self.desc, self.p.p3f, cell.config["accel"])
        self.scene = self.p.build_scene(sd, device=device)
        self.cfg = self.p.RenderConfig(
            max_depth=int(cell.config["max_depth"]),
            engine=cell.config["engine"]).with_scene_flags(self.scene)
        d = self.p.dist
        self.target = d.render_image_sharded(self.scene, self.cfg, None, None)
        scales = d.lr_scales(materials=0.0, light_pos=1.0, light_color=0.0,
                             camera=0.0)
        self.lr = float(cell.traffic["lr"])
        self.step_fn = d.make_train_step(d.train_step_full, self.cfg,
                                         self.lr, scales=scales)

    def start(self, offset: np.ndarray):
        lights = self.scene.lights
        pos = lights.position + torch.from_numpy(offset).to(self.device)
        return dataclasses.replace(self.scene, lights=dataclasses.replace(
            lights, position=pos))

    def step(self, s, spans: bool = False):
        """(scene', loss read on the host, host seconds inside the call);
        with ``spans``, each part inside a profiler range."""
        with trace.span("train_step", spans):
            t0 = time.perf_counter()
            s, loss = self.step_fn(s, self.target, None)
            t1 = time.perf_counter()
        with trace.span("loss_to_host", spans):
            return s, float(loss), t1 - t0

    def release(self):
        self.p.graphs.CACHE.clear()
        self.scene = self.target = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Lockstep:
    """Whether to start job j: decided by rank 0 (time left in the window)
    and shared through the harness's store; alone, decided locally."""

    def __init__(self, rank: int, store):
        self.rank, self.store = rank, store

    def go(self, job: int, wanted: bool) -> bool:
        if self.store is None:
            return wanted
        key = f"go{job}"
        if self.rank == 0:
            self.store.set(key, "1" if wanted else "0")
            return wanted
        return self.store.get(key) == b"1"

    def share(self, key: str, value) -> list:
        """Every rank's ``value`` (JSON) on rank 0; [value] alone."""
        if self.store is None:
            return [value]
        if self.rank > 0:
            self.store.set(f"{key}{self.rank}", json.dumps(value))
            return [value]
        size = int(self.store.get("size"))
        return [value] + [json.loads(self.store.get(f"{key}{r}"))
                          for r in range(1, size)]


def _job(fitter, s, steps, first, record, lat, host, hold=None):
    """Steps ``first`` .. ``steps``-1 of a job from scene ``s``; each
    step's latency (its call and the loss read) and host span appended to
    ``lat`` and ``host``, a non-finite loss as a latency of NaN."""
    check = int(fitter.traffic["check_steps"])
    for i in range(first, steps):
        if hold is not None:
            hold.append(s.lights.position)
        t0 = time.perf_counter()
        s, loss, h = fitter.step(s, hold is not None)
        t1 = time.perf_counter()
        lat.append(t1 - t0 if loss == loss and abs(loss) != float("inf")
                   else float("nan"))
        host.append(h)
        if record is not None and i < check:
            record.losses.append(loss)
            if i == 0:
                record.after_first = s.lights.position
            if i == check - 1:
                record.after_last = s.lights.position
    return s


def session(cell, args, t0, rank, lock, wrap=None):
    """One rank's run: set-up, the window, the traced job; rank 0 returns
    what it measured."""
    device = _device(args, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    traffic = cell.traffic
    fitter = Fitter(cell, device, wrap)
    steps = int(traffic["job_steps"])
    check = int(traffic["check_steps"])
    seed = args.seed
    # set-up: job 0's first steps, the first capture among them
    rec0 = Record(0, job_offset(fitter.desc, traffic, seed, 0))
    lat, host = [], []
    s = _job(fitter, fitter.start(rec0.offset), check, 0, rec0, lat, host)
    sync(device)
    setup_s = time.perf_counter() - t0
    rng = random.Random(f"{seed}:sample")
    lat, host, sampled = [], [], None
    w0 = time.perf_counter()
    _job(fitter, s, steps, check, None, lat, host)
    job = 1
    while lock.go(job, time.perf_counter() - w0 < args.seconds):
        offset = job_offset(fitter.desc, traffic, seed, job)
        rec = None
        if rng.random() < 1.0 / job:   # a reservoir of one window job
            rec = sampled = Record(job, offset)
        _job(fitter, fitter.start(offset), steps, 0, rec, lat, host)
        job += 1
    sync(device)
    wall = time.perf_counter() - w0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    peaks = lock.share("mem", int(peak))
    tr, held = None, []
    if args.trace:
        units = int(traffic["trace_steps"])
        offset = job_offset(fitter.desc, traffic, seed, job)
        tr = trace.traced(lambda: _job(fitter, fitter.start(offset), units,
                                       0, None, [], [], held),
                          units, device)
        spans = lock.share("span", [tr.busy_s, tr.window_s])
        tr.busy_s = sum(b for b, _ in spans) / len(spans)
        tr.window_s = sum(w for _, w in spans) / len(spans)
    held = [h.cpu() for h in held]
    desc, depth = fitter.desc, fitter.cfg.max_depth
    records = [r for r in (rec0, sampled) if r is not None]
    for r in records:
        r.after_first, r.after_last = r.after_first.cpu(), r.after_last.cpu()
    fitter.release()
    fitter.p.dist.leave_group()
    if rank > 0:
        return None
    failed = sum(1 for x in lat if x != x)
    window = Window("step", len(lat), wall, lat, host, setup_s,
                    int(max(peaks)))
    return SimpleNamespace(window=window, records=records, held=held,
                           desc=desc, depth=depth, trace=tr,
                           lr=fitter.lr, device=device,
                           failed=failed)


def _device(args, rank):
    if args.device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank)


def readings(desc, depth, lr, records, device, dtype=torch.float32):
    """The comparison's numbers over ``records`` against the reference in
    ``dtype``."""
    rs = ref.build(desc, device, dtype)
    with torch.no_grad():
        target = ref.render(rs, depth)
    base = ref.build(desc, device).light_pos
    worst = dict.fromkeys(CHECKS, 0.0)
    for r in records:
        start = base + torch.from_numpy(r.offset).to(device)
        losses, pos, g, _ = ref.light_steps(rs, target, start.to(dtype), lr,
                                            len(r.losses), depth)
        start = start.cpu()
        pos, g = pos.float().cpu(), g.float().cpu()
        gaps = [abs(a - b) / abs(b) for a, b in zip(r.losses, losses)]
        if any(x != x for x in gaps):
            gaps = [float("nan")]
        got = dict(
            loss_rel=max(gaps),
            loss_med=statistics.median(gaps),
            grad_rel=_rel_gap((start - r.after_first) / lr, g),
            move_rel=_rel_gap(r.after_last - start, pos[-1] - start))
        for k, v in got.items():
            worst[k] = max(worst[k], v) if v == v else float("nan")
        if dtype == torch.float32:
            print(f"portbench: job {r.job}: losses {r.losses} against "
                  f"{losses}, gaps {gaps}; first gradient norm "
                  f"{float(torch.linalg.vector_norm(g)):.6g}", file=sys.stderr)
    return worst


def _rel_gap(a, b) -> float:
    nb = float(torch.linalg.vector_norm(b))
    return abs(float(torch.linalg.vector_norm(a)) - nb) / nb


def _k1_work(desc, depth, held, device, size):
    """The Whitted kernel's bound, ms, over rank 0's traced steps' forwards:
    its share of the pixels, the first of ``size`` contiguous slices of the
    flat pixel list (the first n mod size slices a pixel longer)."""
    rs = ref.build(desc, device)
    n_tri, n_sph = rs.tri.shape[0], rs.sph.shape[0]
    n = rs.camera["res_x"] * rs.camera["res_y"]
    pixels = n // size + (1 if n % size else 0)
    total = 0.0
    for pos in held:
        stats = {}
        with torch.no_grad():
            ref.render(ref.with_light(rs, pos.to(device)), depth, stats,
                       pixels=slice(0, pixels))
        total += work.whitted_work(stats["queries"], pixels, n_sph, n_tri,
                                   rs.light_pos.shape[0])
    return total


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _children(cell, args, ports, size):
    argv = [sys.executable, "-m", "portbench.run", "--workload", cell.name,
            "--seed", str(args.seed), "--seconds", str(args.seconds),
            "--trace", str(args.trace), "--device", args.device,
            "--override", args.override, "--fault", args.fault,
            "--ports", ",".join(map(str, ports))]
    return [subprocess.Popen(argv + ["--rank", str(r)], cwd=str(ROOT),
                             stdout=sys.stderr,
                             env={**os.environ, "LOCAL_RANK": str(r)})
            for r in range(1, size)]


def _join(cell, args, rank, ports, size):
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    os.environ["LOCAL_RANK"] = str(rank)
    device = "cpu" if args.device == "cpu" else "cuda"
    dist.initialize_multihost(f"127.0.0.1:{ports[0]}", size, rank,
                              device=torch.device(device))


def _store(rank, ports, size):
    from datetime import timedelta

    import torch.distributed as tdist

    return tdist.TCPStore("127.0.0.1", ports[1], size, rank == 0,
                          timedelta(seconds=STORE_TIMEOUT_S),
                          wait_for_workers=False)


def rank_main(cell, args, wrap=None) -> int:
    """A rank above 0 of a cell on several cards."""
    ports = [int(p) for p in args.ports.split(",")]
    size = cell.chips
    store = _store(args.rank, ports, size)
    _join(cell, args, args.rank, ports, size)
    session(cell, args, time.perf_counter(), args.rank,
            Lockstep(args.rank, store), wrap)
    return 0


def run(cell, args, t0: float, wrap=None) -> Outcome:
    size = max(cell.chips, 1)
    children, lock = [], Lockstep(0, None)
    try:
        if size > 1:
            ports = _free_ports(2)
            store = _store(0, ports, size)
            store.set("size", str(size))
            children = _children(cell, args, ports, size)
            _join(cell, args, 0, ports, size)
            lock = Lockstep(0, store)
        out = session(cell, args, t0, 0, lock, wrap)
        for c in children:
            if c.wait(timeout=CHILD_GRACE_S) != 0:
                raise RuntimeError(f"a rank of {cell.name} exited "
                                   f"{c.returncode}")
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    device = out.device
    dev = device_record(device, cell.chips, out.window.peak_bytes, out.trace)
    limits = cell.traffic["limits"]
    c0 = time.perf_counter()
    worst = readings(out.desc, out.depth, out.lr, out.records, device)
    print(f"portbench: reference check of {len(out.records)} jobs "
          f"{time.perf_counter() - c0:.1f} s", file=sys.stderr)
    checks = {k: (worst[k], float(limits[k])) for k in CHECKS}
    works = {}

    def work_of(kind):
        if kind != "k1" or not out.held:
            return None
        if not works:
            works["k1"] = _k1_work(out.desc, out.depth, out.held, device,
                                   size)
        return works["k1"]

    return Outcome(out.window, cell.config, cell.traffic, checks,
                   attempted=out.window.count, failed=out.failed,
                   device=dev, trace=out.trace, work=work_of)


def calibrate(cell, args, seeds, wrap=None):
    """The comparison's readings on each seed: job 0's first steps from the
    seed's offset (no window: the readings need none), and with
    ``args.control`` the control's, the reference computed in bfloat16 in
    the program's place. One card."""
    device = _device(args, 0)
    fitter = Fitter(cell, device, wrap)
    check = int(cell.traffic["check_steps"])
    recs = {}
    for seed in seeds:
        rec = Record(0, job_offset(fitter.desc, cell.traffic, seed, 0))
        _job(fitter, fitter.start(rec.offset), check, 0, rec, [], [])
        rec.after_first, rec.after_last = (rec.after_first.cpu(),
                                           rec.after_last.cpu())
        recs[seed] = rec
    desc, depth, lr = fitter.desc, fitter.cfg.max_depth, fitter.lr
    fitter.release()
    for seed in seeds:
        line = {"seed": seed, "losses": recs[seed].losses,
                "move": float(torch.linalg.vector_norm(
                    recs[seed].after_last - recs[seed].after_first)),
                **readings(desc, depth, lr, [recs[seed]], device)}
        if args.control:
            ctl = _control(desc, depth, lr, recs[seed], device)
            line.update({f"control_{k}": v for k, v in ctl.items()})
        yield line


def _control(desc, depth, lr, rec, device):
    """The readings of the reference in bfloat16 standing in for the
    program, against the reference."""
    rs = ref.build(desc, device, torch.bfloat16)
    with torch.no_grad():
        target = ref.render(rs, depth)
    start = (ref.build(desc, device).light_pos
             + torch.from_numpy(rec.offset).to(device))
    losses, pos, _, _ = ref.light_steps(rs, target, start.to(torch.bfloat16),
                                        lr, len(rec.losses), depth)
    low = Record(0, rec.offset, losses, pos[1].float().cpu(),
                 pos[-1].float().cpu())
    return readings(desc, depth, lr, [low], device)
