"""Phase timers, ray accounting and profiler traces: the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/utils/profiling.py``.

``PhaseTiming``, ``RenderStats`` and ``ray_count`` are JAX's. ``trace``
records a ``torch.profiler`` trace of the CPU and, where there is a card,
CUDA activity, and writes it as a Chrome trace (``trace.json`` in its
directory, for chrome://tracing or Perfetto), in place of JAX's
``xla_trace``. ``device_launches`` counts the hand-written kernels' runs on
the card from the same profiler's kernel events, a CUDA graph's replays
included; ``graph_kernels`` reads the kernel nodes a captured graph holds
from the CUDA driver. JAX's ``enable_compilation_cache`` has no counterpart: it
kept XLA's compiled programs across processes, and the port compiles no
programs at run time except its CUDA kernels, which ``kernels/build.py``
keeps in ``build/kernels/`` by the hash of their sources.

A host clock around device work measures the enqueue unless the work ends
in ``torch.cuda.synchronize()``; a phase that times CUDA work must end in
one (``utils/timing.py`` times frames with CUDA events).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time
from typing import Optional


@dataclasses.dataclass
class PhaseTiming:
    name: str
    seconds: float
    rays: int = 0

    @property
    def mrays_per_s(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds > 0 else 0.0


class RenderStats:
    """Per-phase host timings and the structured metrics lines."""

    def __init__(self):
        self.phases: list[PhaseTiming] = []

    @contextlib.contextmanager
    def phase(self, name: str, rays: int = 0):
        t0 = time.perf_counter()
        yield
        self.phases.append(PhaseTiming(name, time.perf_counter() - t0, rays))

    def report(self) -> str:
        lines = []
        for p in self.phases:
            extra = f" — {p.mrays_per_s:.2f} Mrays/s" if p.rays else ""
            lines.append(f"{p.name}: {p.seconds:.3f}s{extra}")
        return "\n".join(lines)

    def json(self) -> str:
        return json.dumps([dataclasses.asdict(p) for p in self.phases])


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write ``<log_dir>/trace.json`` as a Chrome trace;
    yields the profiler, or None and records nothing without a
    ``log_dir``."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# CUgraphNodeType of a kernel node (cuda.h)
_KERNEL_NODE = 0


def launched(names, kernel: str) -> int:
    """How many of the device kernel events ``names`` ran the ``__global__``
    function ``kernel`` (a whole word of the demangled name, template
    arguments and signature aside: "void closest_kernel<true>(...)")."""
    word = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}(?![A-Za-z0-9_])")
    return sum(bool(word.search(n)) for n in names)


def mangled(names, kernel: str) -> int:
    """How many of the mangled function names ``names`` are the
    ``__global__`` function ``kernel``: its identifier after its length
    ("_ZN..14closest_kernelILb0EEEv..."), or the name itself (extern
    "C")."""
    tag = f"{len(kernel)}{kernel}"
    return sum(n == kernel or tag in n for n in names)


def device_launches(fn, wrappers) -> tuple:
    """(``fn()``, {wrapper name: runs}): how many times the card ran each
    kernel wrapper's device kernel (its ``.device_kernel``) while ``fn``
    ran, counted from ``torch.profiler``'s kernel events, so a launch by the
    wrapper and a CUDA graph's replay of one count alike. Wrappers that
    share a device kernel (``bvh_any`` and ``bvh_any_multi``) cannot be told
    apart, and are refused together. Raises if the profiler saw no device
    event (then nothing can be counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    by_kernel = {}
    for w in wrappers:
        other = by_kernel.setdefault(w.device_kernel, w)
        if other is not w:
            raise ValueError(f"{other.__name__} and {w.__name__} both run "
                             f"{w.device_kernel}: count one of them")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        raise RuntimeError("the profiler saw no device events: the kernels' "
                           "runs cannot be counted")
    return out, {w.__name__: launched(names, w.device_kernel)
                 for w in wrappers}


def graph_kernels(graph) -> list:
    """The ``__global__`` function of each kernel node of ``graph``, a
    ``torch.cuda.CUDAGraph`` that keeps its ``cudaGraph_t`` (made with
    ``keep_graph=True``, as ``utils/graphs.CudaGraphs`` makes them), by its
    mangled name: what every replay of the graph launches, read from the
    CUDA driver (cuGraphGetNodes, cuGraphNodeGetType,
    cuGraphKernelNodeGetParams, cuFuncGetName or cuKernelGetName); "" for
    a kernel node it cannot name."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    kind, name = ctypes.c_int(), ctypes.c_char_p()
    # CUDA_KERNEL_NODE_PARAMS_v2 (72 bytes): func at word 0, kern at word 7
    params = (ctypes.c_uint64 * 16)()
    names = []
    for node in nodes[:n.value]:
        node = ctypes.c_void_p(node)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        check(cu.cuGraphKernelNodeGetParams_v2(node, params),
              "cuGraphKernelNodeGetParams")
        if params[0]:
            rc = cu.cuFuncGetName(ctypes.byref(name),
                                  ctypes.c_void_p(params[0]))
        else:
            rc = cu.cuKernelGetName(ctypes.byref(name),
                                    ctypes.c_void_p(params[7]))
        # a node whose function CUDA cannot name (a library's) is no
        # kernel of the port's
        names.append(name.value.decode() if rc == 0 and name.value else "")
    return names


def ray_count(res_x: int, res_y: int, n_lights: int, spp: int = 0,
              max_depth: int = 4) -> dict:
    """Ray accounting of the Whitted pipeline: the primary rays, primary
    plus top-level shadow rays (the convention of the Mrays/s lines), and
    the whole tree's upper bound (every slot of every level active)."""
    samples = max(spp, 1) ** 2 if spp > 0 else 1
    base = res_x * res_y * samples
    primary_shadow = base * (1 + n_lights)
    slots = (2 ** max_depth) - 1
    upper = base * slots * (1 + n_lights)
    return dict(primary=base, primary_shadow=primary_shadow,
                tree_upper_bound=upper)
