"""The port's inverse-rendering entry points on the CPU: the recoveries of
tests/test_fit_params.py, freeze against zero scales
(tests/test_parallel.py:147), finite geometry gradients on tangential hits
(tests/test_gradients.py:158), with_eye and with_prim_params against the
JAX package's, the FitParams checkpoint in both packages, grad-carrying rays
through every traversal's dispatch, and ``cli fit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
from u_4a_2s_p3d_raytracer_template2_tpu.core.build import (
    with_prim_params as jax_with_prim_params,
)
from u_4a_2s_p3d_raytracer_template2_tpu.ops.camera import (
    with_eye as jax_with_eye,
)
from u_4a_2s_p3d_raytracer_template2_tpu.parallel.dist import (
    params_of as jax_params_of,
)
from u_4a_2s_p3d_raytracer_template2_tpu.utils import (
    checkpoint as jax_checkpoint,
)

from u_4a_2s_p3d_raytracer_template2_tpu_torch import cli
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
    build_scene,
    with_prim_params,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
    RenderConfig,
    Rays,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    mount_scene,
    sphere_field_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    render_image,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import with_eye
from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import checkpoint
from test_torch_grad_fd import mixed, sphere_plane_scene
from torch_parity import (  # one_torch_thread: an autouse fixture
    one_torch_thread,
    soup,
)

CPU = torch.device("cpu")


def test_recover_perturbed_light_position():
    """Light 0 moved by (1.5, -1, 0.8); 12 steps of train_step_full at lr
    100 on the light positions alone cut the loss below a fifth and the
    offset below 0.6 of its start (tests/test_fit_params.py:100)."""
    scene = build_scene(sphere_plane_scene(16), device=CPU)
    cfg = RenderConfig()
    target = render_image(scene, cfg)
    true_pos = scene.lights.position
    delta = torch.zeros_like(true_pos)
    delta[0] = torch.tensor([1.5, -1.0, 0.8])
    s = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, position=true_pos + delta))
    sc = dist.lr_scales(materials=0.0, light_pos=1.0, light_color=0.0,
                        camera=0.0)
    d0 = float((s.lights.position - true_pos).norm())
    losses = []
    for _ in range(12):
        s, loss = dist.train_step_full(s, target, cfg, 100.0, None, sc)
        losses.append(float(loss))
    d1 = float((s.lights.position - true_pos).norm())
    assert losses[-1] < losses[0] * 0.2, losses
    assert d1 < d0 * 0.6, (d0, d1)


def test_recover_displaced_sphere_center():
    """The sphere's centre moved by (0.12, -0.08, 0.1); 15 steps at lr 2
    with the geometry group's scale a mask of its row pull it back
    (tests/test_fit_params.py:137)."""
    scene = build_scene(sphere_plane_scene(16), device=CPU)
    cfg = RenderConfig()
    target = render_image(scene, cfg)
    true_params = scene.prims.params
    delta = torch.zeros_like(true_params)
    delta[0, 0:3] = torch.tensor([0.12, -0.08, 0.1])
    s = with_prim_params(scene, true_params + delta)
    mask = torch.zeros((true_params.shape[0], 1))
    mask[0] = 1.0
    sc = dataclasses.replace(
        dist.lr_scales(materials=0.0, light_pos=0.0, light_color=0.0,
                       camera=0.0, geometry=0.0), prim_params=mask)
    d0 = float((s.prims.params[0, 0:3] - true_params[0, 0:3]).norm())
    losses = []
    for _ in range(15):
        s, loss = dist.train_step_full(s, target, cfg, 2.0, None, sc)
        losses.append(float(loss))
    d1 = float((s.prims.params[0, 0:3] - true_params[0, 0:3]).norm())
    assert losses[-1] < losses[0] * 0.2, losses
    assert d1 < d0 * 0.5, (d0, d1, losses)
    assert s.brute is not scene.brute  # the kernels' tables follow


def test_train_step_lowers_the_loss():
    """train_step (materials alone): the diffuse colours +0.3, three steps
    at lr 1 lower the loss; the projections hold."""
    scene = build_scene(mount_scene(res=12), device=CPU)
    cfg = RenderConfig(max_depth=2)
    target = render_image(scene, cfg)
    s = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials,
        diff_color=(scene.materials.diff_color + 0.3).clamp(0.0, 1.0)))
    losses = []
    for _ in range(3):
        s, loss = dist.train_step(s, target, cfg, 1.0)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    m = s.materials
    assert float(m.diff_color.min()) >= 0.0 and float(m.diff_color.max()) <= 1
    assert float(m.shine.min()) >= 1.0 and float(m.ior.min()) >= 1.0


def test_freeze_matches_zero_scales():
    """freeze detaches groups that zero scales merely leave unchanged: the
    loss and the live groups' updates are equal, the frozen groups
    unchanged in both (tests/test_parallel.py:147)."""
    scene = build_scene(mount_scene(res=8), device=CPU)
    cfg = RenderConfig(max_depth=2)
    target = render_image(scene, cfg)
    sc = dist.lr_scales(materials=1.0, light_pos=1.0, camera=0.0,
                        geometry=0.0)
    s_a, loss_a = dist.train_step_full(scene, target, cfg, 0.05, None, sc)
    s_b, loss_b = dist.train_step_full(scene, target, cfg, 0.05, None, sc,
                                       ("geometry", "camera"))
    assert float(loss_a) == float(loss_b)
    for f in dataclasses.fields(s_a.materials):
        np.testing.assert_allclose(getattr(s_a.materials, f.name).numpy(),
                                   getattr(s_b.materials, f.name).numpy(),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s_a.lights.position.numpy(),
                               s_b.lights.position.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(s_b.camera.eye.numpy(),
                                  scene.camera.eye.numpy())
    np.testing.assert_array_equal(s_b.prims.params.numpy(),
                                  s_a.prims.params.numpy())


def test_geometry_gradient_finite_on_tangential_hits():
    """The sphere field at 48x48, depth 3, its largest sphere displaced:
    the table's gradient is finite where the walk takes a hit that the
    re-intersection rejects (tests/test_gradients.py:158)."""
    scene = build_scene(sphere_field_scene(res=48), device=CPU)
    tp = scene.prims.params
    rows = torch.nonzero(scene.prims.ptype == C.SPHERE)[:, 0]
    row = int(rows[torch.argmax(tp[rows, 3])])
    delta = torch.zeros_like(tp)
    delta[row, 0:3] = torch.tensor([0.8, -0.5, 0.6]) * (0.4 * tp[row, 3])
    leaf = (tp + delta).requires_grad_()
    img = render_image(with_prim_params(scene, leaf),
                       RenderConfig(max_depth=3))
    (g,) = torch.autograd.grad(img.mean(), leaf)
    assert bool(torch.isfinite(g).all()), int((~torch.isfinite(g)).sum())
    assert float(g[row].abs().max()) > 0.0


def test_with_eye_and_with_prim_params_match_jax():
    """The mixed scene with a moved eye and a moved table: the camera's
    frame and every view of the table equal the JAX package's; the
    brute-force tables are repacked from the moved table and the
    accelerator tables are kept."""
    sd = mixed(10)
    jscene = rt.build_scene(mixed_scene_jax(10))
    scene = build_scene(sd, device=CPU, accel=C.ACCEL_BVH)
    eye = np.float32([0.7, 1.3, 5.6])
    jcam = jax_with_eye(jscene.camera, jnp.asarray(eye))
    cam = with_eye(scene.camera, torch.from_numpy(eye))
    for f in ("eye", "u", "v", "n", "plane_dist"):
        np.testing.assert_allclose(getattr(cam, f).numpy(),
                                   np.asarray(getattr(jcam, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    rng = np.random.default_rng(4)
    moved = (scene.prims.params.numpy()
             + rng.normal(0, 0.05, scene.prims.params.shape).astype(
                 np.float32))
    jp = jax_with_prim_params(jscene, jnp.asarray(moved)).prims
    new = with_prim_params(scene, torch.from_numpy(moved))
    for f in ("params", "tri_p", "sph_p", "pl_p", "box_p"):
        np.testing.assert_allclose(getattr(new.prims, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    want = intersect.brute_tables(new.prims)
    assert torch.equal(new.brute.sph, want.sph)
    assert torch.equal(new.brute.tri, want.tri)
    assert not torch.equal(new.brute.sph, scene.brute.sph)
    assert new.packets is scene.packets and new.bvh is scene.bvh
    assert not new.cache


def mixed_scene_jax(res):
    from torch_parity import mixed_scene

    return mixed_scene(rt.SceneDef(), res=res)


def _port_params(seed=0):
    scene = build_scene(mount_scene(res=8), device=CPU)
    rng = np.random.default_rng(seed)
    return dist.tree_map(
        lambda x: torch.from_numpy(
            rng.random(tuple(x.shape)).astype(np.float32)),
        dist.params_of(scene))


def test_checkpoint_round_trip_and_across_packages(tmp_path):
    """A FitParams checkpoint (npz): the port's resumes in the port and in
    JAX's utils/checkpoint.restore (its leaves in JAX's flatten order),
    JAX's resumes in the port, and a file of the wrong leaf count or shape
    raises."""
    p = _port_params(1)
    mine = str(tmp_path / "port")
    checkpoint.save(mine, p)
    back = checkpoint.restore(mine, _port_params(2))
    for a, b in zip(dist.tree_leaves(back), dist.tree_leaves(p)):
        assert torch.equal(a, b)
    jlike = jax_params_of(rt.build_scene(_jax_mount(8)))
    jback = jax_checkpoint.restore(mine, jlike)
    for a, b in zip(jax.tree.leaves(jback), dist.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # JAX's save writes an orbax directory where orbax imports; its npz
    # format (the one the port shares) is the leaves in flatten order
    theirs = str(tmp_path / "jax")
    np.savez(theirs + ".npz", *[np.asarray(x)
                                for x in jax.tree.leaves(jback)])
    got = checkpoint.restore(theirs, _port_params(3))
    for a, b in zip(dist.tree_leaves(got), dist.tree_leaves(p)):
        assert torch.equal(a, b)

    leaves = [x.numpy() for x in dist.tree_leaves(p)]
    np.savez(str(tmp_path / "short.npz"), *leaves[:-1])
    with pytest.raises(ValueError, match="11 arrays"):
        checkpoint.restore(str(tmp_path / "short"), p)
    np.savez(str(tmp_path / "shape.npz"), *leaves[:-1], leaves[-1][:4])
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path / "shape"), p)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), p)


def _jax_mount(res):
    from u_4a_2s_p3d_raytracer_template2_tpu.models.scenes import (
        mount_scene as jax_mount_scene,
    )

    return jax_mount_scene(res=res)


@pytest.mark.parametrize("accel, impl", [
    (C.ACCEL_BVH, "auto"), (C.ACCEL_NONE, "brute"), (C.ACCEL_BVH, "perray"),
    (C.ACCEL_GRID, "perray")], ids=["walk", "brute", "median_bvh", "grid"])
def test_grad_carrying_rays_through_every_traversal(accel, impl):
    """The eye and a light require grad, so every ray does: the walk,
    brute force (the soup's 52 primitives, over the small path's 48) and
    the per-ray traversals read them detached, return answers without a
    gradient, and the render's gradient is finite."""
    sd = soup(SceneDef(), 40, 12)
    sd.accel_type = accel
    scene = build_scene(sd, device=CPU)
    p0 = dist._leaf_params(dist.params_of(scene))
    s = dist._apply_params(scene, p0)
    img = render_image(s, RenderConfig(max_depth=2, accel_impl=impl))
    g_eye, g_light = torch.autograd.grad(img.mean(), [p0.cam_eye,
                                                      p0.light_pos])
    assert bool(torch.isfinite(g_eye).all()) and float(g_eye.abs().max()) > 0
    assert bool(torch.isfinite(g_light).all())
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import whitted

    o = s.camera.eye.expand(4, 3)
    rays = Rays.make(o, torch.nn.functional.normalize(-o, dim=-1))
    t, oid = whitted.trace_closest(s, rays, RenderConfig(accel_impl=impl))
    occ = whitted.trace_shadow(s, rays, 1.0, RenderConfig(accel_impl=impl))
    assert rays.origin.requires_grad
    assert not (t.requires_grad or occ.requires_grad)


def test_cli_fit_on_cpu(capsys):
    """cli fit prints JAX's lines: the light offset falls under --fit
    lights; --fit materials prints the loss a step."""
    assert cli.main(["fit", "--builtin", "mount", "--res", "12", "--steps",
                     "3", "--fit", "lights", "--lr", "10000", "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    offsets = [float(line.split("light offset")[1]) for line in
               out.splitlines() if "light offset" in line]
    assert len(offsets) == 3 and offsets[-1] < offsets[0], out
    assert cli.main(["fit", "--builtin", "mount", "--res", "8", "--steps",
                     "1", "--fit", "materials", "--device", "cpu"]) == 0
    assert "step 0: loss" in capsys.readouterr().out


def test_cli_fit_refuses_the_default_device_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("the refusal is only observable without a card")
    with pytest.raises(SystemExit) as exc:
        cli.main(["fit", "--res", "8"])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
