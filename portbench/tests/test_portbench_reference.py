"""The plain reference against the port's CPU path, at 16² to 64² on both
configurations' shapes; the reference and the harness import nothing they
may not."""
from __future__ import annotations

import ast
import dataclasses

import numpy as np
import pytest
import torch

from portbench import scenes
from portbench.harness import FORBIDDEN, PKG, PROGRAM
from portbench.reference import whitted as ref

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port():
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io import p3f
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
        scenes as port_scenes,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        render_image,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import with_eye

    return build_scene, RenderConfig, p3f, port_scenes, render_image, with_eye


CASES = [  # (description, accel, engine, size)
    ("balls", 2, "wavefront", 16), ("balls", 0, "wavefront", 32),
    ("balls", 2, "sweep", 32), ("mount", 0, "megakernel", 64),
    ("mount", 0, "sweep", 16),
]


def _desc(kind, res):
    return (scenes.spd_balls(size=2, res=res) if kind == "balls"
            else scenes.mount(res=res))


@pytest.mark.parametrize("kind,accel,engine,res", CASES)
def test_reference_frame_matches_the_port(kind, accel, engine, res):
    build_scene, RenderConfig, p3f, _, render_image, with_eye = _port()
    desc = _desc(kind, res)
    scene = build_scene(scenes.to_scene_def(desc, p3f, accel), device=CPU)
    cfg = RenderConfig(max_depth=4, engine=engine)
    eye = torch.tensor([3.0, -4.0, 2.5])
    moved = dataclasses.replace(scene, camera=with_eye(scene.camera, eye))
    rs = ref.build(desc, CPU)
    for s, r in ((scene, rs), (moved, ref.with_eye(rs, eye))):
        got = render_image(s, cfg)
        want = ref.render(r, 4)
        assert float((got - want).abs().max()) < 1e-6
        assert torch.equal(ref.to_u8(got), ref.to_u8(want))


def test_spd_balls_is_the_published_sphereflake():
    """7,381 spheres at size 4, the first as balls.nff prints them, each
    child tangent to its parent at a third of its radius."""
    desc = scenes.spd_balls()
    sph = np.stack([r[:4] for k, r in zip(desc.kind, desc.data)
                    if k == scenes.SPHERE]).astype(np.float64)
    assert sph.shape[0] == 7381 and len(desc.lights) == 3
    np.testing.assert_array_equal(sph[:4], np.array([
        [0, 0, 0, 0.5], [0.272166, 0.272166, 0.544331, 0.166667],
        [0.420314, 0.420314, 0.618405, 0.0555556],
        [0.470715, 0.470715, 0.598245, 0.0185185]], np.float32))
    # depth first: a sphere's children follow it, nine a sphere
    parent, stack = [], []
    for i, r in enumerate(sph[:, 3]):
        while stack and sph[stack[-1], 3] <= r * 2:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    kids = np.array(parent[1:])
    assert np.bincount(kids).max() == 9
    gap = np.linalg.norm(sph[1:, :3] - sph[kids, :3], axis=1)
    # six significant digits: 1e-6 off at most
    np.testing.assert_allclose(gap, sph[1:, 3] + sph[kids, 3], atol=2e-6)
    np.testing.assert_allclose(sph[1:, 3] * 3, sph[kids, 3], atol=2e-6)


def test_mount_is_the_ports_builtin():
    _, _, p3f, port_scenes, _, _ = _port()
    desc = _desc("mount", 32)
    mine = scenes.to_scene_def(desc, p3f, 0)
    theirs = port_scenes.mount_scene(res=32)
    assert np.array_equal(np.stack([o.params for o in mine.objects]),
                          np.stack([o.params for o in theirs.objects]))
    assert [o.ptype for o in mine.objects] == [o.ptype
                                               for o in theirs.objects]
    assert np.array_equal(np.stack(mine.materials),
                          np.stack(theirs.materials))
    assert np.array_equal(np.stack(mine.lights), np.stack(theirs.lights))
    assert ref.params_of(desc).tobytes() == np.stack(
        [o.params for o in theirs.objects]).tobytes()


def test_reference_light_steps_match_the_ports_step():
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    build_scene, RenderConfig, p3f, _, _, _ = _port()
    desc = scenes.mount(res=16)
    scene = build_scene(scenes.to_scene_def(desc, p3f, 0), device=CPU)
    cfg = RenderConfig(max_depth=4, engine="megakernel")
    target = dist.render_image_sharded(scene, cfg)
    offset = torch.tensor([[1.0, -0.7, 0.5]])
    sc = dist.lr_scales(materials=0.0, light_pos=1.0, light_color=0.0,
                        camera=0.0)
    s = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, position=scene.lights.position + offset))
    losses, positions = [], []
    for _ in range(3):
        s, loss = dist.train_step_full(s, target, cfg, 1e4, scales=sc)
        losses.append(float(loss))
        positions.append(s.lights.position)
    rs = ref.build(desc, CPU)
    rl, rp, g, _ = ref.light_steps(rs, ref.render(rs, 4),
                                   rs.light_pos + offset, 1e4, 3)
    np.testing.assert_allclose(losses, rl, rtol=1e-6)
    for a, b in zip(positions, rp[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-3)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_and_work_import_nothing_of_the_program():
    for sub in ("reference", "work"):
        for path in (PKG / sub).glob("*.py"):
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {PROGRAM, *FORBIDDEN}, path


def test_no_file_of_the_harness_imports_jax():
    for path in PKG.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), path
