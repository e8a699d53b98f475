"""The least time the card could take for a kernel's work: the roofline
bounds of the benchmark's per-layer ``*_roofline`` metrics.

A frozen copy of ``chip_smoke.py``'s ``bound`` and of its per-stage
operation counts (``BRUTE_STAGE_OPS``, ``SPH_CLOSEST`` ...), applied to
counts that the benchmark's own plain reference makes on the cell's inputs
(``reference/whitted.render`` with ``stats``), never to a kernel's
counters. So the count is the same work whatever implements it:

* ``brute_work``: every closest-hit query tests every live ray against
  every triangle and sphere, an any-hit query in table order up to and
  including its first occluder, each test charged by where the reference's
  staging ended it; bytes: the primitives once, the live rays in, every
  slot's answer out and its dead byte in.
* ``walk_work``: the same bytes, and no operations: which tests a tree walk
  needs depends on its tree, so only the bytes every implementation must
  move bound it.
* ``whitted_work``: the Whitted kernel's forward of a frame (K1), charged
  by the reference's stepping: each live node a closest-hit test against
  every primitive, a shaded hit, its (hit, light) pairs, and each shadow
  feeler's tests up to its first occluder; bytes the primitive and light
  rows in and the image out.

Peaks: 67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s, the
H100 SXM data sheet at 700 W.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Operations of one brute-force test by where it ended: a triangle at the
# det gate, the u gate, the v gate, with its t; a sphere at the
# discriminant, with its roots. Counted from the test's formulas, each add,
# subtract, multiply, divide, square root, min, max and compare one
# operation (negation, abs and selects none), plus the compare that folds
# the test's t into the ray's answer.
BRUTE_STAGE_OPS = (16, 28, 46, 53, 21, 31)

# The Whitted kernel's per-test model: a closest-hit test costs 32 per
# sphere and 45 per triangle; a shadow feeler's test 30 per sphere and 45
# per triangle; 80 per hit and light; 120 per hit for the rest of its
# shading.
SPH_CLOSEST, SPH_ANY, TRI_TEST, PER_LIGHT, PER_HIT = 32, 30, 45, 80, 120

# bytes of a row: a sphere's centre and radius and its id; a triangle's v0,
# edges and normal
SPHERE_BYTES, TRIANGLE_BYTES = 20, 48
# the Whitted kernel's table row (geometry and material, 24 floats) and a
# light's (position and colour)
ROW_BYTES, LIGHT_BYTES = 96, 24


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take
    for the work, at the f32 peak outside the tensor cores and at the
    memory rate."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def query_bytes(kind: str, live: int, slots: int, n_sph: int,
                n_tri: int) -> int:
    """Bytes of one closest- or any-hit query: the primitives once, each
    live ray's origin and direction in, each slot's answer out (t and id;
    an occlusion byte) and its dead byte in."""
    out = 8 if kind == "closest" else 1
    return (SPHERE_BYTES * n_sph + TRIANGLE_BYTES * n_tri + 24 * live
            + slots * (out + 1))


def query_flops(stages) -> int:
    """Operations of one query's tests, ``stages`` counted by where each
    ended."""
    return sum(n * ops for n, ops in zip(stages, BRUTE_STAGE_OPS))


def brute_work(queries, slots: int, n_sph: int, n_tri: int) -> float:
    """The bound, ms, of brute-force queries: the sum of each query's."""
    return sum(bound(query_flops(q["stages"]),
                     query_bytes(q["kind"], q["live"], slots, n_sph,
                                 n_tri))[0]
               for q in queries)


def walk_work(queries, slots: int, n_sph: int, n_tri: int) -> float:
    """The bound, ms, of the same queries through a tree walk: bytes
    alone."""
    return sum(bound(0, query_bytes(q["kind"], q["live"], slots, n_sph,
                                    n_tri))[0]
               for q in queries)


def whitted_work(queries, pixels: int, n_sph: int, n_tri: int,
                 n_lights: int) -> float:
    """The bound, ms, of the Whitted kernel on one frame's queries."""
    closest = [q for q in queries if q["kind"] == "closest"]
    tests = sum(q["live"] for q in closest)
    hits = sum(q["hits"] for q in closest)
    tri_any = sum(sum(q["stages"][:4]) for q in queries
                  if q["kind"] == "any")
    sph_any = sum(sum(q["stages"][4:]) for q in queries
                  if q["kind"] == "any")
    flops = (tests * (SPH_CLOSEST * n_sph + TRI_TEST * n_tri)
             + hits * PER_HIT + hits * n_lights * PER_LIGHT
             + sph_any * SPH_ANY + tri_any * TRI_TEST)
    n_bytes = (ROW_BYTES * (n_sph + n_tri) + LIGHT_BYTES * n_lights
               + 12 * pixels)
    return bound(flops, n_bytes)[0]
