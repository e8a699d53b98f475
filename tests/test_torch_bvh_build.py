"""The port's BVH build (accel/bvh.py, accel/sah.py, accel/packets.py)
against the JAX package's object bounds and SAH builder, and the invariants
of the tables the walk reads."""
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


def _meta(tables):
    return tables.nodes[:, 6:8].contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tree_invariants(name):
    scene = pt.build_scene(SCENES[name](), device=CPU)
    params, ptype = _objects(scene)
    tables = scene.packets
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

    bmin, bmax = object_bounds(params, ptype)
    box = tables.nodes[:, :6].numpy()
    meta = _meta(tables)
    depth, stack = 0, [(0, 1)]
    covered = np.zeros(len(rows), int)
    while stack:
        n, level = stack.pop()
        a, count = meta[n]
        if count > 0:  # a leaf: its primitives' boxes lie inside its box
            assert count <= packets.LEAF_SIZE
            ids = row_id[a:a + count]
            assert (bmin[ids] >= box[n, :3]).all()
            assert (bmax[ids] <= box[n, 3:]).all()
            covered[a:a + count] += 1
            depth = max(depth, level)
            continue
        for child in (a, a + 1):  # children lie inside their parent
            assert n < child < len(box)
            assert (box[child, :3] >= box[n, :3]).all()
            assert (box[child, 3:] <= box[n, 3:]).all()
            stack.append((child, level + 1))
    assert (covered == 1).all()
    assert depth == tables.depth <= packets.STACK_DEPTH


def test_a_tree_deeper_than_the_stack_raises(monkeypatch):
    monkeypatch.setattr(packets, "STACK_DEPTH", 3)
    with pytest.raises(ValueError, match="stack"):
        pt.build_scene(SCENES["field"](), device=CPU)


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
        for f in ("nodes", "rows", "planes"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert got.depth == want.depth
