"""Programs captured once as CUDA graphs and replayed: the port's
counterpart of ``jax.jit``.

In the JAX package a frame, a tile or a train step is one ``jax.jit``
executable: traced once per static signature, then dispatched once a
call with the scene, pixels and key as arguments. Here the same program
is the eager PyTorch function, captured once as a ``torch.cuda.CUDAGraph``
on CUDA tensors and replayed on every later call:

  * **Static signature.** ``call`` flattens its arguments (frozen
    dataclasses, tuples and NamedTuples of tensors and plain values) into
    tensor leaves and a spec. The graph cache is keyed by the program's
    name, its static arguments (a ``RenderConfig`` or ``PTConfig``, the
    engine, a tile size), the spec (every leaf's shape, dtype and device,
    every plain value) and the identity of the objects kept whole: the
    tables derived once per scene (``Scene.packets``, ``brute``, ``bvh``,
    ``grid``, the cubemap). ``dataclasses.replace`` of a scene's camera
    keeps all of these, so the viewers' orbit replays one graph.
  * **Arguments, not constants.** Every tensor leaf is a graph input: each
    call copies it into the graph's static buffers (one ``torch.cat`` a
    dtype), replays, and returns clones of the outputs,
    so no result is overwritten by the next replay (a 512² image is
    3 MiB).
  * **Warm-up.** Before the capture the program runs ``WARMUP`` times on a
    side stream, on a scene rebuilt from the static buffers, so that every
    cache is filled eagerly: the kernels' libraries and launch settings
    (``kernels/build.py``, the brute-force grid), the autograd engine's
    streams. A capture records kernels and runs none, so anything a capture
    computes and keeps is garbage until the first replay: the warm-up and
    the capture each rebuild the scene, whose ``Scene.cache`` starts empty,
    so derived tables (the megakernel's) are packed inside the graph from
    its inputs on every replay and never kept outside it.
  * **Draws.** A program that draws takes the caller's ``torch.Generator``.
    The graph owns a generator of its own, registered with it
    (``CUDAGraph.register_generator_state``): each call sets its state from
    the caller's, replays, and sets the caller's from it, so a replay draws
    exactly what the eager call draws from a generator in the same state,
    and leaves the generator where the eager call leaves it.
  * **Launch counts.** The kernels' wrappers count the launches they
    make (``kernels``): the warm-up's, and the ones a capture records. A
    replay runs the graph's kernels without their wrappers; its launches
    are counted on the device (``utils/profiling.device_launches``). A
    graph keeps its ``cudaGraph_t`` (``keep_graph``), so the kernel nodes
    it holds can be read (``utils/profiling.graph_kernels``).
  * **Collectives.** A sharded program (``parallel/dist.py``) may hold an
    NCCL collective: the warm-up runs issue it eagerly, so its
    communicator exists before the capture. ``GraphCache.capture_mode``
    is CUDA's capture mode of every capture: "global" by default, and
    "thread_local" while the process is in a process group (the sharding
    layer sets it: ``dist.join_group``), since the group's own threads
    call CUDA while a capture is open. A replay runs the
    collective, so every rank of the group replays its graph, as every
    rank issues an eager collective; ``dist.leave_group`` drops the
    graphs before the group.
  * **No fallback.** A capture that fails (a host sync in the program,
    ``cudaErrorStreamCaptureUnsupported``) raises, with the op that broke
    it in the chained traceback. The callers decide on the device alone:
    CPU tensors run the eager function, CUDA tensors the graph.

**Spans** (``utils/profiling.span``): ``rt.call`` around a whole call;
inside it ``rt.signature`` (the arguments flattened, the key looked up),
``rt.capture`` (warm-up and capture, where one happens), ``rt.copy_in``
(the inputs into the static buffers, the generator's state into the
graph's), ``rt.launch`` (the replay: ``cudaGraphLaunch``) and
``rt.outputs`` (the caller's generator's state, the clones).

``CACHE.captures`` counts the captures of the process; ``CACHE.clear()``
frees the graphs (their memory pools) and keeps the count. The cache keeps
the ``PER_PROGRAM`` graphs of a program that were called last, so a process
that renders one new scene after another holds a bounded number of memory
pools and scenes' tables.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from .profiling import span

# eager runs of a program before its capture
WARMUP = 2
# graphs a program keeps in the cache (the least recently called go first)
PER_PROGRAM = 4


# ---------------------------------------------------------------------------
# trees of tensors


def flatten(tree, keep=frozenset()):
    """(leaves, spec, kept) of ``tree``: its tensors in order, a hashable
    spec of its structure (types, field names, plain values, each leaf's
    shape, dtype and device), and the objects of the dataclass fields named
    in ``keep``, which stay whole (the spec holds their position)."""
    leaves, kept = [], []
    spec = _flatten(tree, frozenset(keep), leaves, kept)
    return leaves, spec, kept


# a dataclass's fields that are part of its value (not Scene.cache), by
# class: dataclasses.fields is slow, and flatten runs every call
_FIELDS = {}


def _value_fields(x):
    """The init fields of dataclass instance ``x``, or None for anything
    else."""
    cls = type(x)
    try:
        return _FIELDS[cls]
    except KeyError:
        names = (tuple(f.name for f in dataclasses.fields(cls) if f.init)
                 if dataclasses.is_dataclass(cls) else None)
        _FIELDS[cls] = names
        return names


def _flatten(x, keep, leaves, kept):
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    names = _value_fields(x)
    if names is not None:
        fields = []
        for name in names:
            v = getattr(x, name)
            if name in keep:
                kept.append(v)
                fields.append((name, ("kept", len(kept) - 1)))
            else:
                fields.append((name, _flatten(v, keep, leaves, kept)))
        return ("dataclass", type(x), tuple(fields))
    if isinstance(x, tuple):
        return ("tuple", type(x),
                tuple(_flatten(v, keep, leaves, kept) for v in x))
    return ("value", x)


def unflatten(spec, leaves, kept):
    """The tree of ``spec`` with ``leaves`` in place of its tensors and
    ``kept`` in place of its whole objects; dataclasses are built anew
    (a Scene with an empty ``cache``)."""
    it = iter(leaves)
    return _unflatten(spec, it, kept)


def _unflatten(spec, it, kept):
    kind = spec[0]
    if kind == "tensor":
        return next(it)
    if kind == "kept":
        return kept[spec[1]]
    if kind == "dataclass":
        return spec[1](**{name: _unflatten(s, it, kept)
                          for name, s in spec[2]})
    if kind == "tuple":
        items = [_unflatten(s, it, kept) for s in spec[2]]
        return tuple(items) if spec[1] is tuple else spec[1](*items)
    return spec[1]


# ---------------------------------------------------------------------------
# capture and replay


class CudaGraphs:
    """What a capture and a replay ask of CUDA (the CPU tests stand a fake
    in its place)."""

    def warm_up(self, device, run) -> None:
        """``run()`` on a side stream, the current stream waiting for it."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(device).wait_stream(side)

    def capture(self, device, run, generator, mode="global"):
        """(graph, outputs): ``run()`` captured on a side stream into a CUDA
        graph with a memory pool of its own, ``generator`` (or None)
        registered with it, in capture mode ``mode`` (``capture_error_mode``),
        and instantiated; the graph keeps its ``cudaGraph_t``. An error
        inside ``run`` propagates as it was raised, after the capture is
        ended and the stream restored."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(device)
        side = torch.cuda.Stream(device)
        with torch.cuda.device(device), torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode=mode)
            try:
                out = run()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the error being raised invalidated the capture
                raise
            graph.capture_end()
            graph.instantiate()
        torch.cuda.current_stream(device).wait_stream(side)
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()

    def reserved_mib(self, device) -> float:
        return torch.cuda.memory_reserved(device) / 2**20


def _generator_like(generator):
    """A new generator on ``generator``'s device in its state (None for
    None)."""
    if generator is None:
        return None
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return g


class Graph:
    """One program captured as a CUDA graph: its static input buffers, its
    static outputs and the generator it draws from. ``fn(inputs,
    generator)`` is the program on a list of tensors."""

    def __init__(self, name: str, fn: Callable, backend):
        self.name = name
        self.fn = fn
        self.backend = backend
        self.graph = None
        self.inputs = None
        self.outputs = None
        self.out_spec = None
        self.out_kept = None
        self.generator = None
        self.replays = 0
        self.capture_ms = None
        self.pool_mib = None

    def capture(self, leaves, generator, keep=frozenset(),
                mode="global") -> None:
        if not leaves:
            raise ValueError(f"{self.name}: a program without tensor inputs "
                             "has no device to capture on")
        device = leaves[0].device
        self._make_inputs(leaves)
        if generator is not None:
            self.generator = torch.Generator(device=device)
        for _ in range(WARMUP):
            self.backend.warm_up(device, lambda: self.fn(
                self.inputs, _generator_like(generator)))
        reserved = self.backend.reserved_mib(device)
        t0 = time.perf_counter()
        try:
            self.graph, out = self.backend.capture(
                device, lambda: self.fn(self.inputs, self.generator),
                self.generator, mode)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing {self.name} as a CUDA graph failed; the op that "
                "broke the capture is in the traceback above (a host sync, "
                "such as .item(), nonzero() or a copy from host memory, "
                "cannot be captured)") from e
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_mib = self.backend.reserved_mib(device) - reserved
        self.outputs, self.out_spec, self.out_kept = flatten(out, keep)

    def _make_inputs(self, leaves) -> None:
        """The static input buffers: one flat buffer a dtype, each input a
        view of it, so that a call copies its arguments in with one
        ``torch.cat`` a dtype (one launch, where a copy a leaf is one
        launch and one host call each)."""
        self.inputs = [None] * len(leaves)
        self.buffers = []
        by_dtype = {}
        for i, x in enumerate(leaves):
            by_dtype.setdefault(x.dtype, []).append(i)
        for idx in by_dtype.values():
            buf = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
            start = 0
            for i in idx:
                n = leaves[i].numel()
                self.inputs[i] = buf[start:start + n].view(leaves[i].shape)
                start += n
            self.buffers.append((buf, idx))

    def copy_in(self, leaves) -> None:
        for buf, idx in self.buffers:
            torch.cat([leaves[i].detach().reshape(-1) for i in idx], out=buf)

    def enter(self, generator) -> None:
        """The graph's generator in the caller's state."""
        if self.generator is not None:
            self.generator.set_state(generator.get_state())

    def leave(self, generator) -> None:
        """The caller's generator advanced as the replay advanced the
        graph's."""
        if self.generator is not None:
            generator.set_state(self.generator.get_state())

    def __call__(self, leaves, generator=None):
        with span("rt.copy_in"):
            self.copy_in(leaves)
            self.enter(generator)
        with span("rt.launch"):
            self.backend.replay(self.graph)
        self.replays += 1
        with span("rt.outputs"):
            self.leave(generator)
            return unflatten(self.out_spec,
                             [x.clone() for x in self.outputs], self.out_kept)


class GraphCache:
    """The captured programs of a process, by static signature (the
    ``PER_PROGRAM`` called last of each program), how many captures there
    were, and the capture mode of the next ones (module doc)."""

    def __init__(self, backend=None):
        self.backend = CudaGraphs() if backend is None else backend
        self.graphs = {}
        self.captures = 0
        self.capture_mode = "global"

    def clear(self) -> None:
        """Drop every graph and its memory pool (the count stays)."""
        self.graphs.clear()

    def call(self, name: str, fn: Callable, args: tuple, generator=None, *,
             static=(), keep=frozenset()):
        """``fn(*args, generator)`` as a replay of its graph, captured at
        the first call with this signature: ``name``, ``static`` (hashable
        arguments the program is specialised on), the structure of
        ``args`` and the identity of their fields named in ``keep``
        (module doc). Returns clones of the outputs; on the dataclass
        fields named in ``keep`` the outputs hold the objects themselves."""
        with span("rt.call"):
            with span("rt.signature"):
                leaves, spec, kept = flatten(args, keep)
                key = (name, static, spec, tuple(map(id, kept)),
                       generator is not None)
                graph = self.graphs.pop(key, None)
            if graph is None:
                with span("rt.capture"):
                    graph = Graph(name, lambda xs, g: fn(
                        *unflatten(spec, xs, kept), g), self.backend)
                    graph.capture(leaves, generator, keep, self.capture_mode)
                    self.captures += 1
                    self._evict(name)
            # the entry holds ``kept`` (through fn), so no id in a key is
            # reused while its graph lives; the dict's order is the order of
            # last use
            self.graphs[key] = graph
            return graph(leaves, generator)

    def _evict(self, name: str) -> None:
        """Drop the least recently called graphs of program ``name`` until
        a new one leaves it ``PER_PROGRAM``."""
        mine = [k for k in self.graphs if k[0] == name]
        for k in mine[:max(0, len(mine) + 1 - PER_PROGRAM)]:
            del self.graphs[k]


# the process's graphs
CACHE = GraphCache()


def on_card(device) -> bool:
    """Whether a program on ``device`` runs as a graph (CUDA) rather than
    eagerly (the CPU)."""
    return torch.device(device).type == "cuda"
