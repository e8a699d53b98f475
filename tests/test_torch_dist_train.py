"""The port's sharded train steps (parallel/dist.train_step_full and
train_step over two gloo ranks on the CPU) against JAX's train_step_full on
a mesh of 2, against the port's own world-1 step, and the cases of
tests/test_parallel.py: ``freeze`` equal to zero scales, and the loss
falling over 8 steps of train_step.

The case is tests/test_parallel.py's freeze test: mount_low at 8x8, depth
2, lr 0.05, materials and light positions updated (camera and geometry
scales 0), here against a target of 0.9 times JAX's image (so the gradient
is not zero). JAX's step is in tests/fixtures/dist_jax_refs.npz
(tests/make_dist_fixture.py: the program compiles for about 16 s); the
live test renders JAX's sharded image of the case, whose loss against the
target is the fixture's. Tolerances: the loss to 1e-5 relative against JAX
(a sum of 192 f32 squares in another order) and each group's update to
JAX's gradient tolerance (tests/test_torch_grad_parity.py: max |a - b| <=
5e-3 max |a| + 1e-6); against the port's world-1 step, where only the
order of the two ranks' sums differs, 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as jrt
from u_4a_2s_p3d_raytracer_template2_tpu.models.scenes import (
    mount_scene as jax_mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu.parallel import dist as jdist

from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    render_image,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist, launch

import torch_dist_workers as workers
from conftest import assert_images_close
from make_dist_fixture import FIXTURE, N_LEAVES, jax_train_image
from torch_parity import one_torch_thread  # noqa: F401

REFS = np.load(FIXTURE)

SPAWN_TIMEOUT_S = 90.0
# FitParams leaves (dist.tree_leaves order) by group: the seven material
# fields, light positions and colours, the camera's eye and focal ratio
GROUPS = {"materials": range(0, 7), "light_pos": (7,), "light_color": (8,),
          "camera": (9, 10)}


def close(got, want, what):
    """JAX's gradient tolerance: max |a - b| <= 5e-3 max |a| + 1e-6."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max(initial=0.0)
    lim = 5e-3 * np.abs(want).max(initial=0.0) + 1e-6
    assert err <= lim, f"{what}: max abs err {err:.3g} over {lim:.3g}"


@pytest.fixture(scope="module")
def target():
    return torch.from_numpy(REFS["train/target"])


@pytest.fixture(scope="module")
def ranks(target):
    return launch.run(workers.train_rank, 2, target,
                      timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def start_leaves():
    return [x.numpy() for x in
            dist.tree_leaves(dist.params_of(workers.train_scene()))]


def test_replicas_stay_equal(ranks):
    a, b = ranks
    assert a["full"][0] == b["full"][0]
    for x, y in zip(a["full"][1], b["full"][1]):
        assert torch.equal(x, y)
    assert a["losses"] == b["losses"]


def test_live_jax_holds_the_fixture(target):
    """JAX's sharded image of the case on 2 of the 8 virtual CPU devices,
    rendered live: its loss against the target is the fixture's step
    loss, and the port's image is within the repo's image rule of it."""
    mesh = jdist.default_mesh(2)
    jscene = jrt.build_scene(jax_mount_scene(res=workers.TRAIN_RES))
    img = jax_train_image(jscene, mesh)
    loss = ((img - target.numpy()) ** 2).sum() / float(img.shape[0]
                                                       * img.shape[1])
    np.testing.assert_allclose(loss, REFS["train/loss"], rtol=1e-6)
    torch.set_num_threads(1)
    assert_images_close(render_image(workers.train_scene(),
                                     workers.train_config()).numpy(), img)


def test_against_jax_mesh_of_two(ranks, start_leaves):
    """JAX's train_step_full on a mesh of 2: the same scene, target, lr
    and scales."""
    loss, leaves = ranks[0]["full"]
    np.testing.assert_allclose(loss, float(REFS["train/loss"]), rtol=1e-5)
    want = [REFS[f"train/leaf_{i}"] for i in range(N_LEAVES)]
    for group, idx in GROUPS.items():
        got = np.concatenate([(leaves[i].numpy() - start_leaves[i]).ravel()
                              for i in idx])
        ref = np.concatenate([(want[i] - start_leaves[i]).ravel()
                              for i in idx])
        close(got, ref, f"{group} update")
    assert np.abs(leaves[7].numpy() - start_leaves[7]).max() > 0


def test_against_world_one(ranks, target):
    loss, leaves = workers.full_step(target)
    got_loss, got = ranks[0]["full"]
    np.testing.assert_allclose(got_loss, loss, rtol=1e-6)
    for i, (x, y) in enumerate(zip(got, leaves)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=f"leaf {i}")


def test_freeze_matches_zero_scales(ranks, start_leaves):
    """``freeze`` detaches the camera and geometry, whose scales are
    already 0: the loss and the live groups' updates are the same."""
    for r in ranks:
        (loss_a, a), (loss_b, b) = r["full"], r["frozen"]
        assert loss_a == loss_b
        for i in (*GROUPS["materials"], *GROUPS["light_pos"]):
            np.testing.assert_allclose(a[i].numpy(), b[i].numpy(),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(b[9].numpy(), start_leaves[9])


def test_train_step_reduces_loss(ranks):
    losses = ranks[0]["losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.5, losses
