"""The two megakernels, the BVH walk and the per-ray traversals on the
card: what ptxas gave them, how many blocks an SM holds, their SASS, and
their time on the main paths' inputs by block size and against another
checkout's build of them.

The kernels are K1/K2 (``csrc/whitted_megakernel.cu``), K3
(``csrc/pt_megakernel.cu``), K5 (``csrc/bvh_walk.cu``) and the four
per-ray kernels (``csrc/perray_traverse.cu``). For each source this
prints:

  * ptxas's registers, spills and stack frame for each kernel instantiation
    (the Whitted kernel's depths 1-8);
  * the blocks an SM holds at the main path's shared memory, counted from
    the registers;
  * the SASS size of each kernel and of each loop in it (``cuobjdump
    -sass``; a loop is a backward branch), a static count;
  * the time of each kernel at 64, 128 and 256 threads a block, measured in
    turns on the main paths' inputs. The copies are built with ``kThreads``
    edited, keeping threads x the minimum blocks at 512 where the source
    sets a minimum, so the register cap stays the same.

The inputs are mount_low 512², depth 4 (one launch); a subpixel launch of
the 512² distribution frame (spp 4, jittered soft shadows, fuzzy
reflection, a 6x2048² u8 sky); and glsl_world 512², 10 bounces. The walk's
are the BVH frame's 12 queries (the 7,396-sphere field at 512², depth 4,
sweep engine: a closest hit a level, a shadow query a level and light, with
the dead masks the sweep hands them; ``frame_queries``) of seven drifting
frames, each launch timed alone with its live slots printed; beside the
times, the share of lanes busy on the primaries and the level-1 rays (each
ray's node tests against its warp's largest, ``warp_max_sum``), over the
slots as laid out and over the live slots packed in slot order. The
per-ray kernels' are the P1 and P2 frames' 12 queries each (the same
field as a BVH and as a grid scene, accel_impl="perray": a closest hit a
level, a shadow query a level and light) of seven drifting frames, each
launch timed alone, the primitives' table packed once for the scene as
a frame packs it once for its 12 queries (``kernels._prims_rows``, both
builds); each build's launch with every slot dead (its floor: the
live-slot pack and the dead answers of 262,144 or 524,288 slots, no
walk); and the compiled P1, P2 and P2q frames, with the BVH sweep's as
the control, under each build (``perray_frames_in_turns``), an earlier
build of the arrays layout also as it shipped, its primitives' table
packed at every query.

``--baseline DIR`` names the ``csrc/`` of another checkout, such as an
earlier commit unpacked with ``git archive``. Its kernels are built the
same way and timed in turns with this checkout's: baseline, this, this,
baseline. The megakernels' tables are cut down to the rows they read; a
walk reads the tree of its source's node width (``walk_width``): the
binary walk of PRs 3-8 the binary tables (``accel/packets
.binary_tables``) through its own entry points, which take no dead mask
for the closest hit; its answers are compared on the live slots. A
per-ray source of the earlier layout (the JAX package's arrays: the node
boxes, flags and indices, the object order and every cell's max_per_cell
slots; ``perray_layout``) is called through wrappers of its own entry
points, its primitive table by object id; every build's answers and
frames are compared on every slot.

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.megakernels \\
        [--baseline DIR] [--threads 64 128 256] [--kernels bvh_walk ...]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import gc
import re
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from ..kernels import build as kb

KERNELS = ("whitted_megakernel", "pt_megakernel")
WALK = "bvh_walk"
PERRAY = "perray_traverse"

# compute capability 9.0 (CUDA C++ Programming Guide, "Technical
# Specifications per Compute Capability"): registers an SM, the register
# allocation unit of a warp, resident warps and blocks an SM, shared memory
# an SM and the 1 KB the runtime reserves a block
SM_REGS, REG_UNIT, SM_WARPS, SM_BLOCKS = 65536, 256, 64, 32
SM_SMEM, BLOCK_SMEM_RESERVED = 233472, 1024

# the row widths of the tables each layout's kernel reads, and the columns
# of the current rows it keeps: the rows before the pad columns
ROW_COLUMNS = {
    ("whitted_megakernel", 23): list(range(23)),
    ("pt_megakernel", 21): list(range(9)) + list(range(12, 24)),
}


def thread_edits(text: str, threads: int):
    """The edits that set a source's block size to ``threads``, keeping
    threads x the minimum blocks of its launch bounds as they are."""
    edits = [("constexpr int kThreads = 128;",
              f"constexpr int kThreads = {threads};")]
    if "__launch_bounds__(kThreads, 4)" in text:
        edits.append(("__launch_bounds__(kThreads, 4)",
                      f"__launch_bounds__(kThreads, {512 // threads})"))
    m = re.search(r"constexpr int kMinBlocks = (\d+);", text)
    if m:
        edits.append((m.group(0), f"constexpr int kMinBlocks = "
                      f"{int(m.group(1)) * 128 // threads};"))
    return edits


def min_block_edits(text: str, blocks: int):
    """The edit that sets a source's kMinBlocks to ``blocks``, or None for
    a source without one."""
    m = re.search(r"constexpr int kMinBlocks = (\d+);", text)
    return None if m is None else [
        (m.group(0), f"constexpr int kMinBlocks = {blocks};")]


def ptxas_resources(log: str) -> dict[str, dict]:
    """{kernel: {"registers", "spill_stores", "spill_loads", "stack"}} from
    ptxas's ``-v`` report, by demangled-enough name (the template argument
    kept: ``whitted_kernel<4>``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = demangle(m.group(1))
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            out[name]["smem"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def demangle(symbol: str) -> str:
    """``whitted_kernel<4>`` from ``_ZN12_GLOBAL__N_114whitted_kernelILi4EE
    Ev6Params``, ``closest_kernel<true>`` from a symbol with ``ILb1E``,
    ``median_bvh_any_kernel<false, 16>`` from one with ``ILb0ELi16EE``,
    ``pt_kernel`` from its symbol; other names as they are."""
    m = re.search(r"([a-z_]+_kernel)((?:IL[ib]\d+E)?(?:L[ib]\d+E)*)",
                  symbol)
    if not m:
        return symbol
    args = [n if kind == "i" else ("true" if n == "1" else "false")
            for kind, n in re.findall(r"L([ib])(\d+)E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)


def blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Resident blocks an SM at ``registers`` a thread, ``threads`` a
    block and ``smem`` bytes of dynamic shared memory a block."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // REG_UNIT) * REG_UNIT
    by_regs = (SM_REGS // per_warp) // warps if per_warp else SM_BLOCKS
    by_smem = SM_SMEM // (smem + BLOCK_SMEM_RESERVED)
    return min(SM_BLOCKS, SM_WARPS // warps, by_regs, by_smem)


def sass_loops(text: str) -> dict[str, dict]:
    """{kernel: {"instructions", "loops"}} from ``cuobjdump -sass``: every
    instruction of each kernel, and the size in instructions of each loop
    (a branch back to an earlier address: the instructions from its target
    to itself), in address order."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = demangle(m.group(1))
            out[name] = {"instructions": 0, "loops": []}
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if not (m and name):
            continue
        addr, ins = int(m.group(1), 16), m.group(2)
        out[name]["instructions"] += 1
        b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if b and int(b.group(1), 16) < addr:
            out[name]["loops"].append((addr - int(b.group(1), 16)) // 16 + 1)
    return out


def sass_text(lib: Path) -> str:
    cuobjdump = kb.nvcc().replace("nvcc", "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def row_width(src_dir: Path, name: str) -> int:
    """The row width the source's kernel reads (its ``kTblW`` or
    ``kRowW``)."""
    text = (src_dir / f"{name}.cu").read_text()
    return int(re.search(r"constexpr int k(?:TblW|RowW) = (\d+);",
                         text).group(1))


def main_inputs(dev):
    """The main paths' launches, as {label: (kernel name, [args of the
    wrapper])}: mount_low 512² depth 4 (and 8, the deepest template) on
    seven drifting ray sets; the 16
    subpixel launches of a 512² distribution frame; glsl_world 512², 10
    bounces, on six frames' draws."""
    from ..core.build import build_scene
    from ..core.types import RenderConfig
    from ..models import pathtracer as pt
    from ..models import pt_megakernel as ptk
    from ..models import samples
    from ..models import whitted_megakernel as mk
    from ..models.glsl_scene import glsl_camera, glsl_world
    from ..models.scenes import mount_scene
    from ..models.whitted import pixel_grid, subpixel_rays
    from ..ops.camera import pinhole_rays
    from .device_validate import distribution_scene

    res = 512
    px, py = pixel_grid(res, res, dev)
    scene = build_scene(mount_scene(res=res), device=dev)
    cfg = RenderConfig(engine="megakernel")
    tables, shape = mk.scene_tables(scene), mk.shape_of(scene)
    mount, mount8 = [], []
    cfg8 = RenderConfig(engine="megakernel", max_depth=8)
    for i in range(7):
        r = pinhole_rays(scene.camera, px + 0.5 + 0.37 * i, py + 0.5)
        o, d = r.origin.contiguous(), r.direction.contiguous()
        mount.append((*tables, o, d, shape, cfg))
        mount8.append((*tables, o, d, shape, cfg8))
    with tempfile.TemporaryDirectory() as env:
        dscene, dcfg = distribution_scene(dev, env_dir=env, res=res)
    plan = samples.draw_plan(torch.Generator(device=dev).manual_seed(1),
                             samples.scene_layout(dscene, dcfg), dcfg,
                             res * res)
    dtables, dshape = mk.scene_tables(dscene), mk.shape_of(dscene)
    sky = mk.sky_of(dscene, dcfg)
    dist = []
    for s in plan:
        r = subpixel_rays(dscene, px, py, dcfg, s)
        dist.append((*dtables, r.origin.contiguous(),
                     r.direction.contiguous(), dshape, dcfg, s.rows, sky,
                     s.ij))
    world, cam = glsl_world(device=dev), glsl_camera(res, res, device=dev)
    ptcfg, pttables = pt.PTConfig(), ptk.pt_tables(world)
    glsl = []
    for i in range(6):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        rays = pt.camera_rays(cam, g)
        uni = pt.draw_uniforms(g, ptcfg.max_bounces, res * res)
        glsl.append((pttables, rays.origin, rays.direction, rays.time, uni,
                     ptcfg))
    return {"mount_low 512^2 depth 4": ("whitted_megakernel", mount),
            "mount_low 512^2 depth 8": ("whitted_megakernel", mount8),
            "distribution 512^2, a subpixel launch":
                ("whitted_megakernel", dist),
            "glsl_world 512^2, 10 bounces": ("pt_megakernel", glsl)}


def with_rows(name: str, width: int, args):
    """``args`` of the wrapper with the tables cut to the rows of a kernel
    that reads ``width`` floats a row."""
    from ..models import pt_megakernel as ptk
    from ..models import whitted_megakernel as mk

    cols = ROW_COLUMNS.get((name, width))
    current = mk.TBL_W if name == "whitted_megakernel" else ptk.ROW_W
    if cols is None or width == current:
        return args
    if name == "whitted_megakernel":
        tbl = args[0].reshape(-1, mk.TBL_W)[:, cols].contiguous().reshape(-1)
        return (tbl, *args[1:])
    t = args[0]
    tbl = t.tbl.reshape(-1, ptk.ROW_W)[:, cols].contiguous().reshape(-1)
    return (t._replace(tbl=tbl), *args[1:])


@contextlib.contextmanager
def entry(name: str, lib: Path | None, width: int):
    """Route the wrapper of kernel ``name`` through the library ``lib``
    (None: the sound build) whose kernel reads ``width`` floats a row."""
    from .. import kernels

    attr = {"whitted_megakernel": "_whitted_entry",
            "pt_megakernel": "_pt_entry"}[name]
    width_attr = {"whitted_megakernel": "TBL_W",
                  "pt_megakernel": "ROW_W"}[name]
    sound = getattr(kernels, attr)()
    fn = sound
    if lib is not None:
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        fn.restype, fn.argtypes = sound.restype, sound.argtypes
    old_width = getattr(kernels, width_attr)
    setattr(kernels, attr, lambda: fn)
    setattr(kernels, width_attr, width)
    try:
        yield getattr(kernels, name)
    finally:
        setattr(kernels, attr, lambda: sound)
        setattr(kernels, width_attr, old_width)


def answers(inputs, builds) -> dict:
    """{(label, build): equal}: whether each build of ``builds`` answers
    each input's first launch as the first build does, bit for bit; each
    reading is printed."""
    first, out = {}, {}
    for tag, name, lib, width in builds:
        for label, (kname, args) in inputs.items():
            if kname != name:
                continue
            with entry(name, lib, width) as fn:
                got = fn(*with_rows(name, width, args[0]))
            want = first.setdefault(label, got)
            out[label, tag] = torch.equal(got, want)
            print(f"answers {tag} | {label}: " + (
                "equal to " if out[label, tag] else
                f"max abs diff {float((got - want).abs().max()):.3g} from ")
                + builds[0][0], flush=True)
    return out


def timed_in_turns(inputs, builds, rounds: int = 2) -> dict:
    """{(label, build): [ms, ...]}: each build of ``builds`` ((tag, kernel
    name, library or None, row width)) timed on each input of its kernel
    with the launches queued (utils/timing.queued_ms), in the order
    A, B, ..., B, A, ``rounds`` times; each time and each build's median
    is printed."""
    from ..utils.timing import queued_ms

    times = {}
    for _ in range(rounds):
        for tag, name, lib, width in list(builds) + list(builds)[::-1]:
            for label, (kname, args) in inputs.items():
                if kname != name:
                    continue
                with entry(name, lib, width) as fn:
                    ms = queued_ms(fn, [with_rows(name, width, a)
                                        for a in args])
                times.setdefault((label, tag), []).append(ms)
                print(f"time {tag} | {label}: {ms:.4f} ms a launch",
                      flush=True)
    for (label, tag), ms in times.items():
        print(f"median {tag} | {label}: {statistics.median(ms):.4f} ms a "
              f"launch ({', '.join(f'{m:.4f}' for m in ms)})", flush=True)
    return times


def report(lib: Path, tag: str, smem: int, threads: int) -> None:
    """Print the library's ptxas resources, blocks an SM (at ``smem``
    bytes of dynamic shared memory and each kernel's static) and SASS
    sizes."""
    log = lib.with_suffix(".log").read_text()
    for kern, r in ptxas_resources(log).items():
        shared = smem + r.get("smem", 0)
        print(f"resources {tag} {kern}: {r['registers']} registers, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
              f"spill loads, {r['stack']} B stack; "
              f"{blocks_per_sm(r['registers'], threads, shared)} blocks of "
              f"{threads} an SM at {shared} B shared")
    try:
        sass = sass_loops(sass_text(lib))
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"sass {tag}: cuobjdump unavailable ({e})")
        return
    for kern, s in sass.items():
        print(f"sass {tag} {kern}: {s['instructions']} instructions, loops "
              f"of {s['loops']}")


# ---------------------------------------------------------------------------
# the BVH walk (csrc/bvh_walk.cu) on the BVH frame's queries

WALK_SIDE, WALK_RES, WALK_FRAMES = 86, 512, 7


def frame_queries(scene, o, d, cfg):
    """The accelerator queries of one frame of ``scene`` from the primary
    rays (o, d), recorded as the sweep (models/whitted.trace_rays) hands
    them to the walk or to brute force (``whitted.trace_closest``,
    ``trace_shadow``): ``closest``, one (o, d, dead) a level; ``shadows``,
    one (o, d, max_t, dead) a level and light."""
    from ..core.types import Rays
    from ..models import whitted

    closest, shadows = [], []
    fns = whitted.trace_closest, whitted.trace_shadow

    def record_closest(scene, rays, cfg=None, dead=None):
        closest.append((rays.origin.contiguous(), rays.direction.contiguous(),
                        dead))
        return fns[0](scene, rays, cfg, dead)

    def record_shadow(scene, rays, max_t, cfg=None, dead=None):
        shadows.append((rays.origin.contiguous(), rays.direction.contiguous(),
                        float(max_t), dead))
        return fns[1](scene, rays, max_t, cfg, dead)

    whitted.trace_closest, whitted.trace_shadow = record_closest, record_shadow
    try:
        whitted.trace_rays(scene, Rays.make(o, d), cfg)
    finally:
        whitted.trace_closest, whitted.trace_shadow = fns
    return closest, shadows


def warp_max_sum(per_ray):
    """The sum over warps of 32 consecutive rays of each warp's largest
    count: the steps a warp takes when its lanes step together."""
    pad = (-per_ray.shape[0]) % 32
    return int(torch.nn.functional.pad(per_ray, (0, pad)).view(-1, 32)
               .amax(dim=1).sum())


def walk_width(src_dir: Path) -> int:
    """The node width of the source's walk (its ``kWidth``), or 0 for the
    binary walk of PRs 3-8: nodes [Nn, 8], and a closest hit that takes no
    dead mask."""
    m = re.search(r"constexpr int kWidth = (\d+);",
                  (src_dir / f"{WALK}.cu").read_text())
    return int(m.group(1)) if m else 0


def walk_inputs(dev):
    """(scene, frames): the BVH frame's scene (the 7,396-sphere field at
    512²) and the walk queries (``frame_queries``) of WALK_FRAMES frames,
    the pixel grid drifting 0.37 px a frame. The sweep that makes them
    runs under ``accel_impl="brute"``, whose answers are the walk's, so
    the queries do not depend on the builds being timed."""
    from ..core.build import build_scene
    from ..core.types import RenderConfig
    from ..models.scenes import sphere_field_scene
    from ..models.whitted import pixel_grid
    from ..ops.camera import pinhole_rays

    scene = build_scene(sphere_field_scene(n_side=WALK_SIDE, res=WALK_RES),
                        device=dev)
    px, py = pixel_grid(WALK_RES, WALK_RES, dev)
    frames = []
    for i in range(WALK_FRAMES):
        r = pinhole_rays(scene.camera, px + 0.5 + 0.37 * i, py + 0.5)
        frames.append(frame_queries(scene, r.origin.contiguous(),
                                    r.direction.contiguous(),
                                    RenderConfig(accel_impl="brute")))
    return scene, frames


def walk_launches(frames):
    """The frame's launches as (label, query, pick): a closest hit a level,
    then a shadow query a level and light; ``pick(frame)`` is the query's
    (o, d, dead) or (o, d, max_t, dead)."""
    closest, shadows = frames[0]
    n_lights = len(shadows) // len(closest)
    return ([(f"closest, level {lvl}", "closest",
              lambda f, lvl=lvl: f[0][lvl]) for lvl in range(len(closest))]
            + [(f"any, level {lvl}, light {li}", "any",
                lambda f, k=lvl * n_lights + li: f[1][k])
               for lvl in range(len(closest)) for li in range(n_lights)])


def walk_tables(scene, width: int):
    """The scene's tree for a walk of ``width``-wide nodes (0: the binary
    tables of PRs 3-8)."""
    from ..accel import packets

    if width == packets.WIDTH:
        return scene.packets
    n = scene.n_objects
    args = (scene.prims.params[:n].cpu().numpy(),
            scene.prims.ptype[:n].cpu().numpy())
    if width == 0:
        return packets.binary_tables(*args, device=scene.device)
    return packets.build_packets(*args, device=scene.device, width=width)


def _binary_calls(lib: Path):
    """(closest, any) through the binary walk of PRs 3-8 in ``lib``: its
    closest hit traces every slot (it takes no dead mask)."""
    so = ctypes.CDLL(str(lib))
    c, a = so.bvh_closest_launch, so.bvh_any_launch
    c.restype = a.restype = ctypes.c_int
    c.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 3)
    a.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                  + [ctypes.c_float, ctypes.c_void_p]
                  + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 2)

    def ptr(x):
        return None if x is None else x.data_ptr()

    def tables(pt):
        return [pt.nodes.data_ptr(), pt.rows.data_ptr(),
                pt.planes.data_ptr(), pt.planes.shape[0]]

    def closest(pt, o, d, dead=None, counts=None):
        R = o.shape[0]
        t = torch.empty(R, device=o.device)
        obj = torch.empty(R, dtype=torch.int32, device=o.device)
        rc = c(torch.cuda.current_stream(o.device).cuda_stream, o.data_ptr(),
               d.data_ptr(), R, *tables(pt), t.data_ptr(), obj.data_ptr(),
               ptr(counts))
        if rc:
            raise RuntimeError(f"binary closest launch failed: CUDA error "
                               f"{rc}")
        return t, obj

    def any_hit(pt, o, d, max_t, dead=None, counts=None):
        out = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
        rc = a(torch.cuda.current_stream(o.device).cuda_stream, o.data_ptr(),
               d.data_ptr(), 1, o.shape[0], max_t, ptr(dead), *tables(pt),
               out.data_ptr(), ptr(counts))
        if rc:
            raise RuntimeError(f"binary any launch failed: CUDA error {rc}")
        return out

    return closest, any_hit


@contextlib.contextmanager
def walk_calls(lib: Path | None, width: int):
    """(closest(tables, o, d, dead, counts=None), any(tables, o, d, max_t,
    dead, counts=None)) through the walk of ``lib`` (None: the sound
    build) whose nodes are ``width`` wide (0: the binary walk of PRs
    3-8); a library of this source's entry points is routed through the
    wrappers of kernels/."""
    from .. import kernels

    if width == 0:
        yield _binary_calls(lib)
        return
    sound = kernels._bvh_entry
    if lib is not None:
        so = ctypes.CDLL(str(lib))
        fns = {}
        for n in ("bvh_closest_launch", "bvh_any_launch"):
            fns[n] = getattr(so, n)
            fns[n].restype, fns[n].argtypes = (sound(n).restype,
                                               sound(n).argtypes)
        kernels._bvh_entry = lambda n: fns[n]
    try:
        yield kernels.bvh_closest, kernels.bvh_any
    finally:
        kernels._bvh_entry = sound


def _walk_run(calls, query, tables, args, counts=None):
    closest, any_hit = calls
    fn = closest if query == "closest" else any_hit
    return fn(tables, *args, counts=counts)


def walk_answers(scene, frames, builds) -> dict:
    """{(label, build tag): equal}: whether each build answers the first
    frame's launches as the first build does, bit for bit: on every slot,
    or on the live slots where a binary walk of PRs 3-8 (which traces dead
    closest-hit slots) is among the builds; then each build's share of busy
    lanes on the primaries and the level-1 rays, printed. ``builds``: (tag,
    library or None, width)."""
    out, first = {}, {}
    every_slot = all(width for _, _, width in builds)
    for tag, lib, width in builds:
        tables = walk_tables(scene, width)
        with walk_calls(lib, width) as calls:
            for label, query, pick in walk_launches(frames):
                args = pick(frames[0])
                got = _walk_run(calls, query, tables, args)
                got = got if isinstance(got, tuple) else (got,)
                if args[-1] is not None and not every_slot:
                    got = tuple(g[~args[-1]] for g in got)
                want = first.setdefault(label, got)
                out[label, tag] = all(torch.equal(g, w)
                                      for g, w in zip(got, want))
                print(f"answers {tag} | {label}: "
                      + ("equal to " if out[label, tag] else "differ from ")
                      + builds[0][0], flush=True)
            for lvl in (0, 1):
                o, d, dead = frames[0][0][lvl]
                counts = torch.zeros((o.shape[0], 9), dtype=torch.int32,
                                     device=o.device)
                _walk_run(calls, "closest", tables, (o, d, dead), counts)
                nodes = counts[:, 0].long()
                live = (torch.ones_like(nodes, dtype=torch.bool)
                        if dead is None else ~dead)
                packed = nodes[live]
                print(f"lanes {tag} | closest, level {lvl}: "
                      f"{int(live.sum())} live of {o.shape[0]} slots, "
                      f"{float(packed.float().mean()):.3f} node tests a live "
                      f"ray; busy lanes {_lanes(nodes):.4f} over the slots "
                      f"as laid out, {_lanes(packed):.4f} over the live "
                      f"slots packed in slot order", flush=True)
    return out


def _lanes(per_ray) -> float:
    steps = warp_max_sum(per_ray)
    return float(per_ray.sum()) / (32 * steps) if steps else 1.0


def walk_timed_in_turns(scene, frames, builds, rounds: int = 2) -> dict:
    """{(label, build tag): [ms, ...]}: each build's launches of the
    frame, each label over WALK_FRAMES frames with the launches queued
    (utils/timing.queued_ms), builds in the order A, B, ..., B, A,
    ``rounds`` times; each time, each build's frame sum and medians are
    printed."""
    from ..utils.timing import queued_ms

    tables = {tag: walk_tables(scene, width) for tag, _, width in builds}
    times = {}
    for _ in range(rounds):
        for tag, lib, width in list(builds) + list(builds)[::-1]:
            total = 0.0
            with walk_calls(lib, width) as calls:
                for label, query, pick in walk_launches(frames):
                    ms = queued_ms(
                        lambda *a, q=query: _walk_run(calls, q, a[0], a[1:]),
                        [(tables[tag], *pick(f)) for f in frames])
                    times.setdefault((label, tag), []).append(ms)
                    total += ms
                    args = pick(frames[0])
                    dead = args[-1]
                    slots = args[0].shape[0]
                    live = slots if dead is None else int((~dead).sum())
                    print(f"time {tag} | {label}: {ms:.4f} ms a launch "
                          f"({live} live of {slots} slots)", flush=True)
            times.setdefault(("frame", tag), []).append(total)
            print(f"time {tag} | the frame's {len(walk_launches(frames))} "
                  f"launches: {total:.4f} ms", flush=True)
    for (label, tag), ms in times.items():
        print(f"median {tag} | {label}: {statistics.median(ms):.4f} ms "
              f"({', '.join(f'{m:.4f}' for m in ms)})", flush=True)
    return times


# ---------------------------------------------------------------------------
# the per-ray traversals (csrc/perray_traverse.cu) on the P1 and P2 frames'
# queries

PERRAY_ENTRIES = ("median_bvh_closest_launch", "median_bvh_any_launch",
                  "grid_closest_launch", "grid_any_launch")
# the compiled frames timed with each per-ray build: (label, kind, config
# keywords); the BVH sweep walks neither build's kernels (csrc/bvh_walk.cu)
# and shows how far the card drifts between turns
PERRAY_FRAMES = (("P1", "bvh", {"accel_impl": "perray"}),
                 ("P2", "grid", {"accel_impl": "perray"}),
                 ("P2q", "grid", {"accel_impl": "perray",
                                  "reference_grid_shadow_initfail": True}),
                 ("BVH sweep", "bvh", {}))


def perray_layout(src_dir: Path) -> str:
    """"packed" for a source that walks kernels.perray_bvh_table's records
    and perray_grid_table's items, "arrays" for the earlier one (commit
    efff919), which reads the JAX package's arrays (BvhArrays,
    GridArrays) as they are."""
    text = (src_dir / f"{PERRAY}.cu").read_text()
    return ("packed" if "const float* nodes, int n_records" in text
            else "arrays")


def _arrays_argtypes(name: str) -> list:
    """The C arguments of the arrays layout's entry point ``name``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    head = [vp, vp, vp, i] + ([ctypes.c_float] if "any" in name else [])
    head += ([i] if name == "grid_any_launch" else []) + [vp]
    accel = ([vp] * 5 + [i, vp, i] if name.startswith("median_bvh")
             else [vp] * 3 + [i] * 4)
    out = [vp] * 3 if name.endswith("closest_launch") else [vp] * 2
    return head + accel + [vp, vp, i] + out


def _arrays_tables(accel) -> list:
    """The arrays layout's table arguments of the tree or grid
    ``accel``."""
    from ..core.types import GridArrays

    if isinstance(accel, GridArrays):
        return [accel.bbox_min.data_ptr(), accel.bbox_max.data_ptr(),
                accel.cell_items.data_ptr(), accel.nx, accel.ny, accel.nz,
                accel.cell_items.shape[1]]
    return [accel.bbox_min.data_ptr(), accel.bbox_max.data_ptr(),
            accel.leaf.data_ptr(), accel.index.data_ptr(),
            accel.n_objs.data_ptr(), accel.leaf.shape[0],
            accel.order.data_ptr(), accel.order.numel()]


def _arrays_wrappers(fns, per_query: bool) -> dict:
    """kernels' four per-ray wrappers over the arrays layout's entry points
    ``fns``, with their signatures: the primitives' table by object id,
    packed once as the sound build's (``kernels._prims_rows``), or at
    every query where ``per_query`` (that build as it shipped), and the
    tree's or grid's arrays as they are."""
    from .. import kernels

    def launch(name, accel, prims, o, d, head, dead, out):
        R = o.shape[0]
        rows = (kernels.perray_rows(prims) if per_query
                else kernels._prims_rows(prims))
        rc = fns[name](torch.cuda.current_stream(o.device).cuda_stream,
                       o.data_ptr(), d.data_ptr(), R, *head,
                       kernels._ptr(dead), *_arrays_tables(accel),
                       rows.data_ptr(), accel.unbounded_ids.data_ptr(),
                       accel.unbounded_ids.numel(),
                       *[t.data_ptr() for t in out], None)
        if rc:
            raise RuntimeError(f"{name} of the arrays layout failed: CUDA "
                               f"error {rc}")
        return out if len(out) > 1 else out[0]

    def closest(name):
        def fn(accel, prims, o, d, dead=None, counts=None, out=None):
            out = out or (torch.empty(o.shape[0], device=o.device),
                          torch.empty(o.shape[0], dtype=torch.int32,
                                      device=o.device))
            return launch(name, accel, prims, o, d, [], dead, out)
        return fn

    def bvh_any(accel, prims, o, d, max_t, dead=None, counts=None,
                out=None):
        out = out if out is not None else torch.empty(
            o.shape[0], dtype=torch.bool, device=o.device)
        return launch("median_bvh_any_launch", accel, prims, o, d,
                      [float(max_t)], dead, (out,))

    def grid_any(grid, prims, o, d, max_t, dead=None,
                 init_fail_occludes=False, counts=None, out=None):
        out = out if out is not None else torch.empty(
            o.shape[0], dtype=torch.bool, device=o.device)
        return launch("grid_any_launch", grid, prims, o, d,
                      [float(max_t), int(init_fail_occludes)], dead, (out,))

    return {"perray_bvh_closest": closest("median_bvh_closest_launch"),
            "perray_bvh_any": bvh_any,
            "grid_closest": closest("grid_closest_launch"),
            "grid_any": grid_any}


@contextlib.contextmanager
def perray_build(lib: Path | None, layout: str):
    """Within the block, kernels' four per-ray wrappers (and so
    accel/traverse.py's dispatchers and the frames that call them) launch
    the kernels of ``lib`` (None: the sound build) of ``layout``
    (perray_layout): a packed build through kernels' own wrappers, the
    arrays layout through wrappers of its own entry points
    (``_arrays_wrappers``; "arrays-per-query": packing the primitives'
    table at every query, as that build shipped)."""
    from .. import kernels

    so = None if lib is None else ctypes.CDLL(str(lib))
    sound = kernels._perray_entry
    wrappers = {n: getattr(kernels, n) for n in (
        "perray_bvh_closest", "perray_bvh_any", "grid_closest", "grid_any")}
    fns = {}
    for n in PERRAY_ENTRIES if so is not None else ():
        fns[n] = getattr(so, n)
        fns[n].restype, fns[n].argtypes = (
            (sound(n).restype, sound(n).argtypes) if layout == "packed"
            else (ctypes.c_int, _arrays_argtypes(n)))
    try:
        if so is not None and layout == "packed":
            kernels._perray_entry = lambda n: fns[n]
        elif so is not None:
            for n, fn in _arrays_wrappers(
                    fns, layout == "arrays-per-query").items():
                setattr(kernels, n, fn)
        yield
    finally:
        kernels._perray_entry = sound
        for n, fn in wrappers.items():
            setattr(kernels, n, fn)


def perray_query(kind, query, scene, args):
    """One query through kernels' per-ray wrapper of ``kind`` ("bvh" or
    "grid"): "closest" with args (o, d, dead), "any" with (o, d, max_t,
    dead, init_fail_occludes)."""
    from .. import kernels

    accel = scene.bvh if kind == "bvh" else scene.grid
    o, d = args[0], args[1]
    if query == "closest":
        fn = (kernels.perray_bvh_closest if kind == "bvh"
              else kernels.grid_closest)
        return fn(accel, scene.prims, o, d, args[2])
    max_t, dead, quirk = args[2:]
    if kind == "bvh":
        return kernels.perray_bvh_any(accel, scene.prims, o, d, max_t, dead)
    return kernels.grid_any(accel, scene.prims, o, d, max_t, dead, quirk)


def perray_inputs(dev):
    """{kind: (scene, frames)}: the field of WALK_SIDE^2 spheres at
    WALK_RES^2 as a BVH ("bvh", P1) and as a grid ("grid", P2) scene, and
    each frame's queries under accel_impl="perray" (frame_queries) of
    WALK_FRAMES frames, the pixel grid drifting 0.37 px a frame."""
    from ..core import constants as C
    from ..core.build import build_scene
    from ..core.types import RenderConfig
    from ..models.scenes import sphere_field_scene
    from ..models.whitted import pixel_grid
    from ..ops.camera import pinhole_rays

    out = {}
    for kind, accel in (("bvh", C.ACCEL_BVH), ("grid", C.ACCEL_GRID)):
        scene = build_scene(sphere_field_scene(
            n_side=WALK_SIDE, res=WALK_RES, accel=accel), device=dev)
        px, py = pixel_grid(WALK_RES, WALK_RES, dev)
        frames = []
        for i in range(WALK_FRAMES):
            r = pinhole_rays(scene.camera, px + 0.5 + 0.37 * i, py + 0.5)
            frames.append(frame_queries(scene, r.origin.contiguous(),
                                        r.direction.contiguous(),
                                        RenderConfig(accel_impl="perray")))
        out[kind] = (scene, frames)
    return out


def _perray_launches(frames):
    """walk_launches' labels, query and pick, with an any hit's
    init_fail_occludes (False) after its dead mask."""
    return [(label, query, pick if query == "closest" else
             (lambda f, pick=pick: (*pick(f), False)))
            for label, query, pick in walk_launches(frames)]


def perray_answers(inputs, builds) -> dict:
    """{(kind, label, build tag): equal}: whether each build answers the
    first frame's launches as the first build does, bit for bit on every
    slot; ``builds``: (tag, library or None, layout)."""
    out, first = {}, {}
    for tag, lib, layout in builds:
        with perray_build(lib, layout):
            for kind, (scene, frames) in inputs.items():
                for label, query, pick in _perray_launches(frames):
                    got = perray_query(kind, query, scene, pick(frames[0]))
                    got = got if isinstance(got, tuple) else (got,)
                    want = first.setdefault((kind, label), got)
                    out[kind, label, tag] = all(
                        torch.equal(g, w) for g, w in zip(got, want))
                    print(f"answers {tag} | perray {kind} {label}: "
                          + ("equal to " if out[kind, label, tag]
                             else "differ from ") + builds[0][0],
                          flush=True)
    return out


def perray_timed_in_turns(inputs, builds, rounds: int = 2) -> dict:
    """{(kind, label, build tag): [ms, ...]}: each build's launches of the
    P1 and P2 frames, each label over WALK_FRAMES frames with the launches
    queued (utils/timing.queued_ms), builds in the order A, B, ..., B, A,
    ``rounds`` times; each time, each build's frame sums and medians are
    printed."""
    from ..utils.timing import queued_ms

    times = {}
    for _ in range(rounds):
        for tag, lib, layout in list(builds) + list(builds)[::-1]:
            with perray_build(lib, layout):
                for kind, (scene, frames) in inputs.items():
                    total = 0.0
                    for label, query, pick in _perray_launches(frames):
                        ms = queued_ms(
                            lambda *a, q=query: perray_query(kind, q, scene,
                                                             a),
                            [pick(f) for f in frames])
                        times.setdefault((kind, label, tag), []).append(ms)
                        total += ms
                        args = pick(frames[0])
                        dead = args[2] if query == "closest" else args[3]
                        slots = args[0].shape[0]
                        live = slots if dead is None else int((~dead).sum())
                        print(f"time {tag} | perray {kind} {label}: "
                              f"{ms:.4f} ms a launch ({live} live of "
                              f"{slots} slots)", flush=True)
                    times.setdefault((kind, "frame", tag), []).append(total)
                    print(f"time {tag} | perray {kind}, the frame's "
                          f"{len(_perray_launches(frames))} launches: "
                          f"{total:.4f} ms", flush=True)
    for (kind, label, tag), ms in times.items():
        print(f"median {tag} | perray {kind} {label}: "
              f"{statistics.median(ms):.4f} ms "
              f"({', '.join(f'{m:.4f}' for m in ms)})", flush=True)
    return times


def perray_floor(inputs, builds) -> dict:
    """{(kind, query, build tag): ms}: each build's closest and any hit
    launch over the slots of the frame's level-1 rays (524,288) and level-0
    shadow segments (262,144) with every slot dead, queued
    (utils/timing.queued_ms): what a launch costs before any walk."""
    from ..utils.timing import queued_ms

    out = {}
    for tag, lib, layout in builds:
        with perray_build(lib, layout):
            for kind, (scene, frames) in inputs.items():
                for label, query, pick in _perray_launches(frames):
                    if label not in ("closest, level 1",
                                     "any, level 0, light 0"):
                        continue
                    args = [list(pick(f)) for f in frames]
                    for a in args:
                        a[2 if query == "closest" else 3] = torch.ones(
                            a[0].shape[0], dtype=torch.bool,
                            device=a[0].device)
                    ms = out[kind, query, tag] = queued_ms(
                        lambda *a, q=query: perray_query(kind, q, scene, a),
                        [tuple(a) for a in args])
                    print(f"floor {tag} | perray {kind} {query}: {ms:.4f} "
                          f"ms a launch of {args[0][0].shape[0]} slots, "
                          "every one dead", flush=True)
    return out


def perray_frames_in_turns(inputs, builds, rounds: int = 3) -> dict:
    """{(frame label, build tag): [ms, ...]}: the compiled frames of
    PERRAY_FRAMES on perray_inputs' scenes (render_image's graph, captured
    anew for each build: utils/timing.frame_ms, the median of 21 frames)
    with each build's per-ray kernels, builds in the order A, B, ..., B, A,
    ``rounds`` times. Each build's image of each frame is compared with
    the first build's, bit for bit. After each turn its graphs are
    dropped and collected (a graph's pool is freed with the graph, which
    a reference cycle can keep until a collection)."""
    from ..core.types import RenderConfig
    from ..models.whitted import render_image
    from ..utils import graphs
    from ..utils.timing import frame_ms

    times, first = {}, {}
    for r in range(rounds):
        for tag, lib, layout in list(builds) + list(builds)[::-1]:
            with perray_build(lib, layout):
                graphs.CACHE.clear()
                for label, kind, kw in PERRAY_FRAMES:
                    scene, cfg = inputs[kind][0], RenderConfig(**kw)
                    if r == 0:
                        img = render_image(scene, cfg, torch.Generator(
                            device=scene.device).manual_seed(5))
                        want = first.setdefault(label, img)
                        print(f"image {tag} | {label}: "
                              + ("equal to " if torch.equal(img, want)
                                 else "differs from ") + builds[0][0],
                              flush=True)
                    ms = frame_ms(scene, cfg)
                    times.setdefault((label, tag), []).append(ms)
                    print(f"frame {tag} | {label} compiled: {ms:.4f} ms",
                          flush=True)
                graphs.CACHE.clear()
                gc.collect()
                torch.cuda.empty_cache()
                print(f"memory {tag} | after the turn: "
                      f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB "
                      "allocated", flush=True)
    for (label, tag), ms in times.items():
        print(f"median {tag} | frame {label} compiled: "
              f"{statistics.median(ms):.4f} ms "
              f"({', '.join(f'{m:.4f}' for m in ms)})", flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="the csrc/ directory of another checkout")
    ap.add_argument("--threads", type=int, nargs="*", default=[64, 128, 256])
    ap.add_argument("--min-blocks", type=int, nargs="*", default=[],
                    help="kMinBlocks values to build at 128 threads, for a "
                    "source that declares it")
    ap.add_argument("--kernels", nargs="*", default=[*KERNELS, WALK],
                    choices=[*KERNELS, WALK, PERRAY])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("megakernels: needs a CUDA card")
    from .device_validate import card_info

    dev = torch.device("cuda", 0)
    print(f"card: {card_info()}")
    mega = [k for k in KERNELS if k in args.kernels]
    inputs = main_inputs(dev) if mega else {}
    sources = [("this", kb.CSRC)]
    if args.baseline is not None:
        sources.insert(0, ("baseline", args.baseline))
    jobs = []  # (build tag, source directory, kernel, block size, edits)
    for tag, src in sources:
        for name in args.kernels:
            text = (src / f"{name}.cu").read_text()
            jobs += [(f"{tag}{n}", src, name, n, thread_edits(text, n))
                     for n in args.threads]
            jobs += [(f"{tag}128m{m}", src, name, 128,
                      min_block_edits(text, m))
                     for m in args.min_blocks
                     if min_block_edits(text, m) is not None]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: kb.build_copy(
            j[2], j[0], j[4], src_dir=j[1]), jobs))
    builds = {name: [] for name in args.kernels}
    for (btag, src, name, n, _), lib in zip(jobs, libs):
        if name == WALK:
            report(lib, btag, 0, n)
            builds[name].append((btag, lib, walk_width(src)))
            continue
        if name == PERRAY:
            report(lib, btag, 0, n)
            builds[name].append((btag, lib, perray_layout(src)))
            continue
        width = row_width(src, name)
        report(lib, btag, smem_of(name, inputs, width), n)
        builds[name].append((btag, name, lib, width))
    for name in mega:
        answers(inputs, builds[name])
        timed_in_turns(inputs, builds[name])
    if WALK in args.kernels:
        scene, frames = walk_inputs(dev)
        walk_answers(scene, frames, builds[WALK])
        walk_timed_in_turns(scene, frames, builds[WALK])
    if PERRAY in args.kernels:
        inputs = perray_inputs(dev)
        perray_answers(inputs, builds[PERRAY])
        perray_timed_in_turns(inputs, builds[PERRAY])
        perray_floor(inputs, builds[PERRAY])
        perray_frames_in_turns(inputs, builds[PERRAY] + [
            (f"{tag}-per-query", lib, "arrays-per-query")
            for tag, lib, layout in builds[PERRAY] if layout == "arrays"])
    return 0


def smem_of(name: str, inputs, width: int) -> int:
    """Dynamic shared memory of the main path's launch of kernel ``name``
    at ``width`` floats a row: its table and its lights."""
    for kname, args in inputs.values():
        if kname != name:
            continue
        if name == "whitted_megakernel":
            shape = args[0][5]
            return 4 * (shape.n * width + 6 * max(1, shape.n_lights))
        t = args[0][0]
        return 4 * ((t.n_sph + t.n_tri) * width + 6 * max(1, t.n_lights))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
