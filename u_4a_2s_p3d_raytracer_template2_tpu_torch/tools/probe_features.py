"""T3 on the card: a tree walk with a per-thread stack in shared memory,
the counterpart of tools/probe_pallas_features.py.

The JAX tool checks that the packet walk's building blocks lower through
Mosaic: a walk over a 3-node tree in the (a, is_leaf) layout of the BVH
tables, with its stack of 64 int32 in SMEM. Here csrc/probes.cu walks the
same layout with one thread per output element, the stack in shared memory
laid out [level][thread] or in a per-thread array (where csrc/bvh_walk.cu
keeps its stack), both held exactly to the plain version and to a NumPy
oracle. A stack that loses entries shows only on a tree deeper than the
probe's, so every run also walks a seeded full binary tree of about the
7,396-sphere field's depth.

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.probe_features
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.probe_features \\
        --device cpu        # the plain version only

On the card it prints ``ALL FEATURES OK`` or raises.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

PACK, LANE, STACK = 256, 128, 64   # the JAX tool's rays, lanes and stack
# PacketTables.depth of sphere_field_scene(n_side=86), the BVH frame's tree
FIELD_DEPTH = 13
# rays a timed walk: one launch of the deep tree runs about a millisecond
TIMED_ROWS = 1 << 18


def probe_tree():
    """The JAX tool's inputs (probe_pallas_features.main): (nbox [18],
    nmeta [6], table [2, 8, 128], rays [256, 8]); node 0 inner with leaves 1
    and 2 of chunks 0 and 1."""
    nbox = np.arange(3 * 6, dtype=np.float32) * 0.001
    nmeta = np.array([1, 0, 0, 1, 1, 1], np.int32)
    table = np.random.RandomState(0).rand(2, 8, LANE).astype(np.float32)
    rays = np.random.RandomState(1).rand(PACK, 8).astype(np.float32)
    return nbox, nmeta, table, rays


def _tables(meta, chunks, rng, rows):
    """nbox, nmeta, table, rays of a tree ``meta`` [(a, is_leaf)] whose
    leaves hold chunks 0..chunks-1."""
    n = len(meta)
    nbox = rng.uniform(0.0, 0.01, 6 * n).astype(np.float32)
    table = rng.random((chunks, 8, LANE), np.float32)
    rays = rng.random((rows, 8), np.float32)
    return nbox, np.asarray(meta, np.int32).reshape(-1), table, rays


def complete_tree(levels: int, seed: int, rows: int = PACK):
    """A complete tree of 2^levels - 1 nodes in breadth-first order (node i
    inner with children 2i+1, 2i+2), its leaves holding the chunks in a
    seeded order."""
    rng = np.random.default_rng(seed)
    inner = 2 ** (levels - 1) - 1
    perm = rng.permutation(inner + 1)
    meta = [(2 * i + 1, 0) for i in range(inner)]
    meta += [(int(c), 1) for c in perm]
    return _tables(meta, inner + 1, rng, rows)


def deep_tree(depth: int, seed: int, rows: int = PACK):
    """A seeded full binary tree whose longest root-to-leaf path has
    ``depth`` nodes: a spine that turns left or right at random, with a
    random bush of height 1-5 beside each step. Left turns leave their right
    sibling on the stack, so a walk holds up to depth - 1 entries."""
    rng = np.random.default_rng(seed)
    meta = [[0, 0]]

    def grow(i, height, spine):
        if height == 1:
            meta[i] = [-1, 1]   # a leaf; its chunk is drawn below
            return
        a = len(meta)
        meta.extend([[0, 0], [0, 0]])
        meta[i] = [a, 0]
        if spine:
            side = int(rng.integers(2))
            grow(a + side, height - 1, True)
            grow(a + 1 - side, int(rng.integers(1, min(height - 1, 5) + 1)),
                 False)
        else:
            for child in (a, a + 1):
                grow(child, int(rng.integers(max(1, height - 2), height)),
                     False)

    grow(0, depth, True)
    leaves = [m for m in meta if m[1] == 1]
    for m, c in zip(leaves, rng.permutation(len(leaves))):
        m[0] = int(c)
    return _tables(meta, len(leaves), rng, rows)


def walk_leaves(nmeta) -> list[tuple[int, int]]:
    """(node, chunk) of each leaf in the order the JAX kernel folds them: an
    inner node pushes a+1 and descends to a, one pop per step. Raises on a
    tree that overflows the 64-entry stack or leaves the tables."""
    meta = [int(v) for v in nmeta]
    n = len(meta) // 2
    stack, sp, cur, out = [0] * STACK, 0, 0, []
    for _ in range(n):
        a, leaf = meta[2 * cur], meta[2 * cur + 1]
        nxt = -1
        if leaf:
            out.append((cur, a))
        else:
            if sp >= STACK or not 0 <= a < n - 1:
                raise ValueError(f"node {cur}: children {a}, {a + 1} or "
                                 f"stack depth {sp} out of range")
            stack[sp] = a + 1
            sp += 1
            nxt = a
        if nxt < 0 and sp > 0:
            sp -= 1
            nxt = stack[sp]
        cur = nxt
        if cur < 0:
            return out
    raise ValueError("the walk visits more nodes than the tree has")


def oracle(nbox, nmeta, table, rays) -> np.ndarray:
    """[P, 128] by recursion over the tree, with no stack: the min over its
    leaves of (table[a, 0] + rays[:, 0]) + nbox[6·node], in NumPy f32."""
    best = np.full((rays.shape[0], LANE), 1e30, np.float32)

    def visit(i):
        nonlocal best
        a, leaf = int(nmeta[2 * i]), int(nmeta[2 * i + 1])
        if leaf:
            best = np.minimum(best, (table[a, 0][None, :] + rays[:, 0:1])
                              + nbox[6 * i])
        else:
            visit(a)
            visit(a + 1)

    visit(0)
    return best


def stack_walk_plain(nbox, nmeta, table, rays) -> torch.Tensor:
    """The plain version of ``kernels.stack_walk``: the leaves in the walk's
    order (``walk_leaves``, on the host), each folded as the JAX kernel
    folds it, (chunk + ray) + b0, then the min."""
    best = torch.full((rays.shape[0], LANE), 1e30, dtype=torch.float32,
                      device=rays.device)
    ray = rays[:, 0:1]
    for node, a in walk_leaves(nmeta.tolist()):
        best = torch.minimum(best, (table[a, 0][None, :] + ray)
                             + nbox[6 * node])
    return best


def walk_cases(depth: int = FIELD_DEPTH, rows: int = PACK):
    """(label, (nbox, nmeta, table, rays)) of the probe's 3-node tree and a
    deep tree of ``depth``."""
    yield "3-node probe tree", probe_tree()
    yield f"deep tree, depth {depth}", deep_tree(depth, seed=6, rows=rows)


def check_walks(device, depth: int = FIELD_DEPTH, rows: int = PACK):
    """Walk every case of ``walk_cases`` with the plain version and, on a
    CUDA device, the kernel with each stack placement; raise unless all
    equal the oracle exactly. Returns the leaves and nodes of each case."""
    from .. import kernels

    out = {}
    for label, arrays in walk_cases(depth, rows):
        want = oracle(*arrays)
        args = [torch.from_numpy(a).to(device) for a in arrays]
        got = {"plain": stack_walk_plain(*args)}
        if torch.device(device).type == "cuda":
            for stack in kernels.STACKS:
                got[stack] = kernels.stack_walk(*args, stack=stack)
        for name, g in got.items():
            if not np.array_equal(g.cpu().numpy(), want):
                raise AssertionError(f"{label}: the {name} walk differs "
                                     "from the oracle")
        n = arrays[1].size // 2
        out[label] = (len(walk_leaves(arrays[1])), n)
        print(f"probe_features {label}: {n} nodes, {out[label][0]} leaves, "
              f"{rows} rays; {', '.join(got)} equal the oracle exactly")
    return out


def time_walks(device, depth: int = FIELD_DEPTH, rows: int = TIMED_ROWS):
    """The deep tree of ``walk_cases`` walked by ``rows`` rays on the card:
    {shared, local (ms a launch of each stack placement, launches queued),
    plain_ms, abs_err (largest difference of either placement from the
    plain version; raises unless 0), nodes, bytes (inputs read once, the
    output written once)}."""
    from .. import kernels
    from ..utils.timing import cuda_ms, queued_ms

    arrays = list(walk_cases(depth, rows))[-1][1]
    args = [torch.from_numpy(a).to(device) for a in arrays]
    want = stack_walk_plain(*args)
    out = {"nodes": arrays[1].size // 2, "abs_err": 0.0,
           "bytes": 4 * (sum(a.size for a in arrays) + rows * LANE)}
    for stack in kernels.STACKS:
        got = kernels.stack_walk(*args, stack=stack)
        if not torch.equal(got, want):
            raise AssertionError(f"the {stack} walk of {rows} rays differs "
                                 "from the plain version")
        out["abs_err"] = max(out["abs_err"],
                             float((got - want).abs().max()))
        out[stack] = queued_ms(lambda *a, s=stack: kernels.stack_walk(
            *a, stack=s), [args] * 3)
    out["plain_ms"] = cuda_ms(stack_walk_plain, [args], warmup=1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--depth", type=int, default=FIELD_DEPTH)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "version only")
    check_walks(device, args.depth)
    if device.type != "cuda":
        print("plain version only (--device cpu): the kernel was not run")
        return 0
    print("ALL FEATURES OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
