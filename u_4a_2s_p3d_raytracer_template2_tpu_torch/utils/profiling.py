"""Program spans, ray accounting and profiler traces: the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/utils/profiling.py``.

``ray_count`` is JAX's. JAX's ``PhaseTiming`` and ``RenderStats`` (a host
clock around work that, on a card, is only enqueued) are not ported; the
span recorder stands in their place:

  * **Spans.** ``span(name)`` around a part of the program: the entry
    calls (``models/whitted.render_image``, ``parallel/dist
    .make_train_step``'s step: ``entry=True``) and the compiled call's
    parts (``utils/graphs.GraphCache.call``). Every name starts with
    ``PREFIX``. Off (the default), ``span`` checks one flag and returns a
    shared no-op context: no clock read, no allocation, no profiler range.
    On (``record_spans(True)`` or ``recording()``), each span keeps its
    name, its start and end on ``time.perf_counter_ns``, the index of the
    span it is nested in and the unit it belongs to, until ``take_spans()``
    hands them over. An entry span outside any unit starts a unit (a frame,
    a train step); the spans inside it share its id; spans outside every
    unit have unit -1. While a ``torch.profiler`` session is active a span
    also opens a profiler range of its name, so the spans sit on the device
    trace's clock. One thread records (the caller's).

``trace`` records a ``torch.profiler`` trace of the CPU and, where there is
a card, CUDA activity, spans on, and writes it as a Chrome trace
(``trace.json`` in its directory, for chrome://tracing or Perfetto), in
place of JAX's ``xla_trace``. ``device_launches`` counts the hand-written
kernels' runs on the card from the same profiler's kernel events, a CUDA
graph's replays included; ``graph_kernels`` reads the kernel nodes a
captured graph holds from the CUDA driver. JAX's
``enable_compilation_cache`` has no counterpart: it kept XLA's compiled
programs across processes, and the port compiles no programs at run time
except its CUDA kernels, which ``kernels/build.py`` keeps in
``build/kernels/`` by the hash of their sources.

A host clock around device work measures the enqueue unless the work ends
in ``torch.cuda.synchronize()`` (``utils/timing.py`` times frames with CUDA
events); a span measures the host's part of the call it wraps.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import time
from typing import Optional

# the prefix of every span's name (a name holds neither "LaunchKernel" nor
# "GraphLaunch", which count a profiler's host launch calls)
PREFIX = "rt."


@dataclasses.dataclass(slots=True)
class Span:
    """A recorded span: ``parent`` the index of the span it is nested in,
    in the list ``take_spans`` returns (-1 for none); ``unit`` the id of
    its frame or step (-1 outside every entry span)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    unit: int


class _Off:
    """The context every span is while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_profiler = None    # torch.autograd.profiler, imported when spans go on
_spans: list = []   # recorded since the last take, in order of start
_open: list = []    # indices of the open spans, innermost last
_units = 0          # units started so far


class _On:
    __slots__ = ("name", "entry", "index", "range")

    def __init__(self, name: str, entry: bool):
        self.name, self.entry, self.range = name, entry, None

    def __enter__(self):
        global _units
        parent = _open[-1] if _open else -1
        unit = _spans[parent].unit if parent >= 0 else -1
        if unit < 0 and self.entry:
            unit = _units
            _units += 1
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        self.index = len(_spans)
        _open.append(self.index)
        _spans.append(Span(self.name, time.perf_counter_ns(), 0, parent,
                           unit))
        return None

    def __exit__(self, *exc):
        _spans[self.index].end_ns = time.perf_counter_ns()
        _open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, entry: bool = False):
    """The context of span ``name`` (module doc); ``entry`` marks an entry
    call, which starts a unit."""
    if not _on:
        return _OFF
    return _On(name, entry)


def record_spans(on: bool) -> bool:
    """Switch the recorder on or off; returns whether it was on."""
    global _on, _profiler
    if on and _profiler is None:
        from torch.autograd import profiler

        _profiler = profiler
    was, _on = _on, bool(on)
    return was


def take_spans() -> list:
    """The spans recorded since the last take, oldest first, and the record
    emptied; taken between units (raises while a span is open)."""
    global _spans
    if _open:
        raise RuntimeError("take_spans while a span is open")
    out, _spans = _spans, []
    return out


@contextlib.contextmanager
def recording():
    """The recorder on for the block; after it, as it was before. Spans
    recorded by a block that switched it on are dropped at its end unless
    taken inside it."""
    was = record_spans(True)
    try:
        yield
    finally:
        record_spans(was)
        if not was and not _open:
            take_spans()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is present), the program's spans on, and write
    ``<log_dir>/trace.json`` as a Chrome trace; yields the profiler, or
    None and records nothing without a ``log_dir``."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with recording(), profile(activities=activities) as prof:
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
