"""Writes tests/fixtures/dist_jax_refs.npz: the JAX package's sharded
references that tests/test_torch_dist_render.py and
tests/test_torch_dist_train.py hold the port's sharding to.

    JAX_PLATFORMS=cpu python tests/make_dist_fixture.py

JAX's programs for these compile for 16-21 s each on an 8-core x86 host
(XLA level 0), too long for a test, so they are computed once here, on a
mesh of 2 of the 8 virtual CPU devices:

  * ``render/mount16``: ``render_image_sharded`` of mount_low at 16x16,
    depth 4, default config;
  * ``train/target``: 0.9 times JAX's image of mount_low at TRAIN_RES,
    depth TRAIN_DEPTH (a target the scene does not match, so the gradient
    is not zero);
  * ``train/loss`` and ``train/leaf_{i}`` (i < 11: the FitParams leaves
    without the primitive table, in the flatten order): one
    ``train_step_full`` from that scene against the target, lr TRAIN_LR,
    scales TRAIN_SCALES (tests/test_parallel.py's freeze test).

The tests recompute a cheaper part live (the train case's sharded image,
whose loss against the target is ``train/loss``), so the fixture stays
the JAX package's answer.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import u_4a_2s_p3d_raytracer_template2_tpu as rt  # noqa: E402
from u_4a_2s_p3d_raytracer_template2_tpu.models.scenes import (  # noqa: E402
    mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu.parallel import dist  # noqa: E402

from torch_dist_workers import (  # noqa: E402
    TRAIN_DEPTH,
    TRAIN_LR,
    TRAIN_RES,
    TRAIN_SCALES,
)
from torch_parity import REFERENCE_COMPILE, jax_reference  # noqa: E402

FIXTURE = os.path.join(HERE, "fixtures", "dist_jax_refs.npz")
MESH = 2
N_LEAVES = 11  # seven material fields, light pos and colour, eye, focal


def train_config():
    return rt.RenderConfig(max_depth=TRAIN_DEPTH)


def jax_train_image(scene, mesh):
    """JAX's sharded image of the train case."""
    return jax_reference(
        lambda s: dist.render_image_sharded(s, train_config(), mesh), scene)


def main():
    jax.config.update("jax_platforms", "cpu")
    mesh = dist.default_mesh(MESH)
    arrays = {"render/mount16": jax_reference(
        lambda s: dist.render_image_sharded(s, rt.RenderConfig(), mesh),
        rt.build_scene(mount_scene(res=16)))}
    scene = rt.build_scene(mount_scene(res=TRAIN_RES))
    target = np.float32(0.9) * jax_train_image(scene, mesh)

    def step(s, tgt):
        new, loss = dist.train_step_full(
            s, tgt, train_config(), mesh, TRAIN_LR, jax.random.PRNGKey(3),
            dist.lr_scales(**TRAIN_SCALES))
        return [loss] + jax.tree.leaves(dist.params_of(new))[:N_LEAVES]

    out = jax.jit(step).lower(scene, target).compile(
        compiler_options=REFERENCE_COMPILE)(scene, target)
    arrays["train/target"] = target
    arrays["train/loss"] = np.float32(out[0])
    for i, x in enumerate(out[1:]):
        arrays[f"train/leaf_{i}"] = np.asarray(x)
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez(FIXTURE, **arrays)
    print(f"wrote {FIXTURE}: {len(arrays)} arrays; train loss "
          f"{float(out[0]):.6g}")


if __name__ == "__main__":
    main()
