"""The port's device probes (the ``tools`` subpackage, csrc/probes.cu)
against the JAX package's tools: T1's and T2's plain versions against NumPy
transcriptions of the JAX kernels' bodies (closures inside the tools, which
cannot be called without editing them), T3's plain version against the JAX
kernel itself in Pallas interpret mode, and the op counter against JAX's.
The kernels themselves are tested on the card by tests/test_torch_cuda.py
and chip_smoke.py."""
import importlib.util
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
    device_validate as dv,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
    probe_features as pf,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
    roofline_mount as rm,
)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
f32 = np.float32


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t1_numpy(x, op, k=512):
    """tools/roofline_mount.py:148-163 in NumPy f32."""
    a = x * f32(1e-9) + f32(0.9999)
    acc = x
    for _ in range(k):
        if op == "fma":
            acc = acc * a + x
        elif op == "cheap":
            acc = np.abs(acc - x)
        elif op == "div":
            acc = x / (acc + f32(1.5))
        elif op == "rsqrt":
            acc = f32(1) / np.sqrt(np.abs(acc) + f32(1.1))
        elif op == "select":
            acc = np.where(acc > x, acc - x, acc + x)
    return acc


@pytest.mark.parametrize("op", rm.OPS)
def test_op_rate_plain_matches_the_jax_chain(op):
    """[64, 128] at K = 512: equal, but for rsqrt (1/sqrt in NumPy, rsqrt in
    PyTorch; the chain contracts, so a 1e-6 relative tolerance)."""
    x = np.random.default_rng(3).uniform(-0.5, 1.5, (64, 128)).astype(f32)
    want = _t1_numpy(x, op)
    got = rm.op_rate_plain(torch.from_numpy(x), op).numpy()
    assert np.isfinite(got).all()
    if op == "rsqrt":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    if op == "cheap":  # negative inputs grow, where max(acc, x) stays at x
        neg = x < 0
        assert neg.any() and (got[neg] > 0).all()


def test_fma_peak_plain_matches_the_jax_chains():
    """tools/device_validate.py:120-135 in NumPy f32 at [256, 128], the JAX
    tool's input: equal."""
    x = np.linspace(0.9, 1.1, 256 * 128, dtype=f32).reshape(256, 128)
    a = x
    b = a * f32(1.0000001) + f32(0.3)
    c = a * f32(0.9999999) - f32(0.2)
    d = a + f32(0.1)
    e = a - f32(0.1)
    for _ in range(512 // 8):
        b = b * a + f32(0.25)
        c = c * a - f32(0.25)
        d = d * a + f32(0.5)
        e = e * a - f32(0.5)
        b = b * f32(1.0000001) + c
        c = c * f32(0.9999998) + d
        d = d * f32(1.0000002) + e
        e = e * f32(0.9999997) + b
    got = dv.fma_peak_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, b + c + d + e)
    assert np.isfinite(got).all() and got.max() > 1e25


def _jax_walk(mod, nbox, nmeta, table, rays):
    """The JAX tool's kernel with its own specs
    (tools/probe_pallas_features.py:87-104), in interpret mode."""
    return np.asarray(pl.pallas_call(
        mod.kernel,
        grid=(1,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
            pl.BlockSpec((mod.PACK, 8), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((mod.PACK, mod.LANE), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((mod.PACK, mod.LANE), jnp.float32),
        scratch_shapes=[
            pltpu.SMEM((64,), jnp.int32),
            pltpu.VMEM((mod.PACK, mod.LANE), jnp.float32),
        ],
        interpret=True,
    )(jnp.asarray(nbox), jnp.asarray(nmeta), jnp.asarray(table),
      jnp.asarray(rays)))


@pytest.mark.parametrize("tree", ["probe", "complete15"])
def test_stack_walk_plain_matches_the_jax_kernel(tree):
    """The probe's 3-node tree, and a seeded 15-node tree of 8 chunks:
    the plain walk, the oracle and the JAX kernel agree exactly (a min of
    sums in one order)."""
    arrays = (pf.probe_tree() if tree == "probe"
              else pf.complete_tree(4, seed=11))
    assert arrays[1].size // 2 == (3 if tree == "probe" else 15)
    want = _jax_walk(_jax_tool("probe_pallas_features"), *arrays)
    got = pf.stack_walk_plain(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pf.oracle(*arrays), want)


def _one_slot_walk(nmeta):
    """walk_leaves with a stack that keeps one entry, each push overwriting
    the last: chip_faults.py's planted T3 fault."""
    meta = [int(v) for v in nmeta]
    top, sp, cur, out = 0, 0, 0, []
    for _ in range(4 * len(meta)):
        a, leaf = meta[2 * cur], meta[2 * cur + 1]
        nxt = -1
        if leaf:
            out.append((cur, a))
        else:
            top, sp, nxt = a + 1, sp + 1, a
        if nxt < 0 and sp > 0:
            sp, nxt = sp - 1, top
        cur = nxt
        if cur < 0:
            return out
    raise AssertionError("the one-slot walk did not end")


def test_the_deep_tree_catches_a_stack_that_loses_entries():
    """The chip's T3 cases: a one-slot stack walks the probe's tree right
    and ends on the deep tree of the field's depth, but misses its
    leaves; every leaf of the deep tree is walked once."""
    (_, probe), (_, deep) = pf.walk_cases()
    nbox, nmeta, table, rays = deep
    assert sorted(a for _, a in pf.walk_leaves(nmeta)) == list(
        range(table.shape[0]))
    np.testing.assert_array_equal(
        pf.stack_walk_plain(*(torch.from_numpy(a) for a in deep)).numpy(),
        pf.oracle(*deep))
    assert _one_slot_walk(probe[1]) == pf.walk_leaves(probe[1])
    lossy = _one_slot_walk(nmeta)
    assert {a for _, a in lossy} != set(range(table.shape[0]))


def _sphere_jnp(ox, oy, oz, dx, dy, dz, cx, cy, cz, r, zero, big):
    ux, uy, uz = ox - cx, oy - cy, oz - cz
    b = ux * dx + uy * dy + uz * dz
    c = ux * ux + uy * uy + uz * uz - r * r
    disc = b * b - c
    root = jnp.sqrt(jnp.maximum(disc, zero))
    t = -b - root
    return jnp.where((disc > zero) & (t > zero), t / (dx * dx + zero), big)


def _sphere_torch(ox, oy, oz, dx, dy, dz, cx, cy, cz, r, zero, big):
    ux, uy, uz = ox - cx, oy - cy, oz - cz
    b = ux * dx + uy * dy + uz * dz
    c = ux * ux + uy * uy + uz * uz - r * r
    disc = b * b - c
    root = torch.sqrt(torch.maximum(disc, zero))
    t = -b - root
    return torch.where((disc > zero) & (t > zero), t / (dx * dx + zero), big)


def test_count_ops_matches_the_jax_count():
    """One sphere test written in jnp and in torch: the port's count_ops and
    JAX's (tools/roofline_mount.py:45) give the same per-class totals, and
    the same answers."""
    jrm = _jax_tool("roofline_mount")
    args = [np.random.default_rng(i).uniform(-1, 1, 128).astype(f32)
            for i in range(10)] + [np.zeros(128, f32),
                                   np.full(128, 1e30, f32)]
    jaxpr = jax.make_jaxpr(_sphere_jnp)(*(jnp.asarray(a) for a in args))
    counts = Counter()
    jrm.count_ops(jaxpr.jaxpr, counts)
    want = {"fma_class": 0.0, "cheap_class": 0.0, "trans_class": 0.0,
            "other": 0.0}
    for k, v in counts.items():
        want["fma_class" if k in jrm.FMA else "cheap_class" if k in jrm.CHEAP
             else "trans_class" if k in jrm.TRANS else "other"] += v
    out, got = rm.count_ops(_sphere_torch,
                            *(torch.from_numpy(a) for a in args))
    assert rm.classify(got) == want
    assert want["trans_class"] == 2 * 128 and want["other"] == 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        _sphere_jnp(*(jnp.asarray(a) for a in args))))


def test_part_mix_counts_the_sweep():
    """The mix of mount_low's sweep on the CPU at 8x8, depth 2: every class
    present, more multiply-adds than anything else."""
    cls = rm.part_mix(torch.device("cpu"), res=8, depth=2)
    assert all(v > 0 for v in cls.values())
    assert cls["fma_class"] == max(cls.values())


def test_probe_wrappers_refuse_cpu_tensors():
    """No fallback: CPU tensors raise before any build."""
    x = torch.zeros(256, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.op_rate(x, "fma")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fma_peak(x)
    nbox, nmeta, table, rays = (torch.from_numpy(a) for a in pf.probe_tree())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stack_walk(nbox, nmeta, table, rays)
