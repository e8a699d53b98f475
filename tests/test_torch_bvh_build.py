"""The port's BVH build (accel/bvh.py, accel/sah.py, accel/packets.py)
against the JAX package's object bounds and SAH builder, the collapse of
the binary SAH tree to four children a node, and the invariants of the
tables the walk reads."""
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.accel.bvh import (
    object_bounds as jax_object_bounds,
)
from u_4a_2s_p3d_raytracer_template2_tpu.accel.sah import (
    sah_build as jax_sah_build,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel.bvh import object_bounds
from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel.sah import sah_build
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
from torch_parity import (  # one_torch_thread: an autouse fixture
    jax_scene_to_port,
    mixed_scene,
    one_torch_thread,
)

CPU = torch.device("cpu")


def _bvh(sd):
    sd.accel_type = C.ACCEL_BVH
    return sd


SCENES = {
    "field": lambda: scenes.sphere_field_scene(n_side=16, res=16),
    "mixed": lambda: _bvh(mixed_scene(pt.SceneDef(), res=16)),
    "random": lambda: scenes.random_scene(16, 12),
}


def _objects(scene):
    n = scene.n_objects
    return (scene.prims.params[:n].numpy(), scene.prims.ptype[:n].numpy())


@pytest.mark.parametrize("name", ["field", "mixed"])
def test_bounds_and_sah_match_jax(name):
    params, ptype = _objects(pt.build_scene(SCENES[name](), device=CPU))
    got = object_bounds(params, ptype)
    want = jax_object_bounds(params, ptype)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b, strict=True)
    bounded = np.nonzero(np.isfinite(got[0]).all(axis=1))[0]
    assert (ptype[bounded] != C.PLANE).all()
    args = (got[0][bounded], got[1][bounded])
    for a, b in zip(sah_build(*args, leaf_size=packets.LEAF_SIZE),
                    jax_sah_build(*args, leaf_size=packets.LEAF_SIZE)):
        np.testing.assert_array_equal(a, b, strict=True)


def _children(nodes, width):
    """Each wide node's children: boxes [Nn, W, 6] (min, max), references
    and counts [Nn, W]."""
    n = nodes.shape[0]
    box = nodes[:, :6 * width].reshape(n, 6, width).transpose(0, 2, 1)
    meta = nodes[:, 6 * width:].view(np.int32)
    return box, meta[:, :width], meta[:, width:]


def _leaves(nodes, width):
    """The wide tree's leaves as (first row, count, box), each reached once
    from the root, and the most entries its walk can hold (the largest sum
    over a root-to-node path of each node's children less one)."""
    box, ref, count = _children(nodes, width)
    leaves, most, stack = [], 0, [(0, 0, None)]
    while stack:
        n, held, parent = stack.pop()
        used = count[n] >= 0
        kids = int(used.sum())
        assert 1 <= kids <= width and used[:kids].all()
        most = max(most, held + kids - 1)
        for c in range(kids):
            if parent is not None:  # a child lies inside its parent
                assert (box[n, c, :3] >= parent[:3]).all()
                assert (box[n, c, 3:] <= parent[3:]).all()
            if count[n, c] > 0:
                leaves.append((int(ref[n, c]), int(count[n, c]), box[n, c]))
            else:
                assert n < ref[n, c] < len(nodes)
                stack.append((int(ref[n, c]), held + kids - 1, box[n, c]))
    return leaves, most


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tree_invariants(name):
    scene = pt.build_scene(SCENES[name](), device=CPU)
    params, ptype = _objects(scene)
    tables = scene.packets
    assert tables.width == packets.WIDTH
    rows = tables.rows.numpy()
    row_type = rows.view(np.int32)[:, 12]
    row_id = rows.view(np.int32)[:, 13]
    # every bounded primitive once, its parameters copied; planes beside
    bounded = np.nonzero(ptype != C.PLANE)[0]
    assert sorted(row_id.tolist()) == bounded.tolist()
    np.testing.assert_array_equal(row_type, ptype[row_id])
    np.testing.assert_array_equal(rows[:, :12], params[row_id])
    planes = tables.planes.numpy().view(np.int32)[:, 13]
    assert planes.tolist() == np.nonzero(ptype == C.PLANE)[0].tolist()

    # a leaf's primitives' boxes lie inside its box; every row in one leaf
    bmin, bmax = object_bounds(params, ptype)
    leaves, most = _leaves(tables.nodes.numpy(), tables.width)
    covered = np.zeros(len(rows), int)
    for first, count, box in leaves:
        assert count <= packets.LEAF_SIZE
        ids = row_id[first:first + count]
        assert (bmin[ids] >= box[:3]).all() and (bmax[ids] <= box[3:]).all()
        covered[first:first + count] += 1
    assert (covered == 1).all()
    assert most == tables.stack <= packets.STACK_DEPTH
    assert tables.depth == packets._binary_build(params, ptype)[3]


def test_a_tree_deeper_than_the_stack_raises(monkeypatch):
    """A tree whose walk could hold more entries than the kernel's stack
    is refused."""
    monkeypatch.setattr(packets, "STACK_DEPTH", 3)
    with pytest.raises(ValueError, match="stack"):
        pt.build_scene(SCENES["field"](), device=CPU)


COLLAPSED = {"mount": lambda: _bvh(scenes.mount_scene(res=16)),
             "field": SCENES["field"], "mixed": SCENES["mixed"]}


@pytest.mark.parametrize("name", sorted(COLLAPSED))
def test_collapse_keeps_the_binary_boxes_and_reaches_every_primitive_once(
        name):
    """Collapsed to four children a node, the tree's child boxes are boxes
    of the binary tree, bit for bit, its leaves are the binary tree's
    leaves, each reached once, so every primitive is reached once; a node
    has fewer than four children only where all are leaves; collapsed to
    two, the tree is the binary tree, an inner node a node."""
    params, ptype = _objects(pt.build_scene(COLLAPSED[name](), device=CPU))
    binary, rows, _, _ = packets._binary_build(params, ptype)
    meta = binary[:, 6:8].view(np.int32)
    inner = meta[:, 1] == 0
    binary_boxes = {binary[i, :6].tobytes() for i in range(len(binary))}
    binary_leaves = sorted(tuple(m) for m in meta[~inner])
    for width in (2, packets.WIDTH):
        nodes, stack = packets._collapse(binary, width)
        assert nodes.shape == (max(1, int(inner.sum())) if width == 2
                               else nodes.shape[0], 8 * width)
        leaves, most = _leaves(nodes, width)
        assert most == stack
        assert sorted((f, c) for f, c, _ in leaves) == binary_leaves
        reached = np.zeros(len(rows), int)
        for first, count, box in leaves:
            reached[first:first + count] += 1
        assert (reached == 1).all()
        box, _, count = _children(nodes, width)
        for n in range(len(nodes)):
            used = count[n] >= 0
            for c in np.nonzero(used)[0]:
                assert box[n, c].astype(np.float32).tobytes() in binary_boxes
            if used.sum() < width and len(nodes) > 1:
                assert (count[n][used] > 0).all()


def test_planes_only_scene_has_no_tree():
    sd = pt.SceneDef()
    sd.set_camera(eye=[0, 1, 5], at=[0, 0, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=8, res_y=8, aperture_ratio=0,
                  focal_ratio=1)
    m = sd.add_material([0.8, 0.3, 0.2], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    sd.add_plane_points([0, -1, 0], [1, -1, 0], [0, -1, -1], m)
    sd.add_light([5, 5, 5], [1, 1, 1])
    scene = pt.build_scene(_bvh(sd), device=CPU)
    assert scene.accel_type == C.ACCEL_BVH and scene.packets is None
    brute = pt.build_scene(sd, device=CPU, accel=C.ACCEL_NONE)
    assert torch.equal(pt.render_image(scene, pt.RenderConfig()),
                       pt.render_image(brute, pt.RenderConfig()))


def test_grid_and_converted_scenes_carry_the_same_tables():
    """A grid scene builds the BVH tables (it routes to the walk, as JAX
    does on the TPU); a JAX BVH scene converts by rebuilding them."""
    want = pt.build_scene(SCENES["mixed"](), device=CPU).packets
    grid = pt.build_scene(SCENES["mixed"](), device=CPU, accel=C.ACCEL_GRID)
    jscene = rt.build_scene(_bvh(mixed_scene(rt.SceneDef(), res=16)))
    for got in (grid.packets, jax_scene_to_port(jscene).packets):
        for f in ("nodes", "rows", "planes"):  # bit for bit: int32 fields
            assert torch.equal(getattr(got, f).view(torch.int32),
                               getattr(want, f).view(torch.int32)), f
        assert (got.depth, got.stack) == (want.depth, want.stack)
