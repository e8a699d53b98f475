"""Writes tests/fixtures/mount_jax_refs.npz: the JAX package's references on
mount_low that tests/test_torch_grad_parity.py (inverse rendering) and
tests/test_torch_wavefront_pin.py hold the port to.

    JAX_PLATFORMS=cpu python tests/make_grad_fixture.py

One ``jax.value_and_grad`` over the whole ``FitParams`` of mount_low at
16x16 takes 30-60 s to compile on an 8-core x86 host, too long for a test,
so the references are computed once here:

  * ``{engine}/loss`` and ``{engine}/grad_{i}`` for the sweep and the
    wavefront at RES, depth 4: the loss ``sum((img - target)²) / n_pixels``
    of the perturbed scene (``perturb``) against the unperturbed scene's
    image ``target``, and its gradient over the FitParams leaves in the
    pytree's flatten order (``dist.tree_leaves`` in the port);
  * ``{engine}/param_{i}`` and ``{engine}/target``: the perturbed scene's
    leaves and the target, as the JAX package computed them;
  * ``step/loss`` and ``step/param_{i}``: the loss and the leaves after
    one ``train_step_full`` (sweep, LR, every group's scale 1, the geometry
    included) from the perturbed scene;
  * ``pin/sweep`` and ``pin/wavefront``: JAX's images of mount_low at
    PIN_RES, depth 4, default config, on the sweep and on the wavefront
    (compiling the sweep's ops takes 15-25 s on that host; the pin test
    renders JAX's wavefront live and reads the sweep from this file);
  * ``live/loss`` and ``live/grad``: ``jax_live``, a small problem of the
    same kind (the light positions' gradient of the loss against a grey
    image at LIVE_RES, depth LIVE_DEPTH) that compiles in seconds, which
    the test recomputes with JAX, so that the fixture stays the JAX
    package's answer.
"""
import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import u_4a_2s_p3d_raytracer_template2_tpu as rt  # noqa: E402
from u_4a_2s_p3d_raytracer_template2_tpu.models.scenes import (  # noqa: E402
    mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu.models.whitted import (  # noqa: E402
    render_tile,
)
from u_4a_2s_p3d_raytracer_template2_tpu.parallel.dist import (  # noqa: E402
    _apply_params,
    default_mesh,
    lr_scales,
    params_of,
    train_step_full,
)

from torch_parity import jax_reference, jax_render_image  # noqa: E402

FIXTURE = os.path.join(HERE, "fixtures", "mount_jax_refs.npz")
RES = 16
ENGINES = ("sweep", "wavefront")
LR = 0.05
N_LEAVES = 12  # seven material fields, light pos and colour, eye, focal, table
PIN_RES = 24
LIVE_RES = 8
LIVE_DEPTH = 1
LIVE_MOVE = (0.3, -0.2, 0.1)  # light 0's offset in the live problem
TRI, SPH = 1, 2  # core/constants: TRIANGLE, SPHERE


def perturb(leaves, ptype):
    """The start of the fit, from the true scene's FitParams leaves (NumPy,
    flatten order): diffuse colours +0.05, light 0 moved by (0.3, -0.2,
    0.1), the eye by (0.05, -0.03, 0.02), the focal ratio +0.01, the largest
    sphere's centre by 0.1 r along (0.8, -0.5, 0.6) and its radius by
    +0.005, and the first triangle's v0 by (0.01, 0.02, -0.01) and its e1 by
    (0.0, 0.01, 0.02)."""
    out = [np.array(x, np.float32, copy=True) for x in leaves]
    out[0] = np.clip(out[0] + 0.05, 0.0, 1.0)
    out[7][0] += np.float32([0.3, -0.2, 0.1])
    out[9] += np.float32([0.05, -0.03, 0.02])
    out[10] = np.asarray(out[10] + np.float32(0.01), np.float32)
    pp = out[11]
    sph = np.nonzero(ptype == SPH)[0]
    row = int(sph[np.argmax(pp[sph, 3])])
    pp[row, 0:3] += np.float32([0.8, -0.5, 0.6]) * (0.1 * pp[row, 3])
    pp[row, 3] += np.float32(0.005)
    tri = int(np.nonzero(ptype == TRI)[0][0])
    pp[tri, 0:3] += np.float32([0.01, 0.02, -0.01])
    pp[tri, 3:6] += np.float32([0.0, 0.01, 0.02])
    return out


def _grid(res):
    ys, xs = jnp.meshgrid(jnp.arange(res, dtype=jnp.float32),
                          jnp.arange(res, dtype=jnp.float32), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def jax_problem(res, engine):
    """(loss function of FitParams, the perturbed scene's FitParams, the
    target image [res, res, 3], the perturbed scene) of the JAX package at
    ``res``, depth 4, on ``engine``."""
    scene = rt.build_scene(mount_scene(res=res))
    cfg = rt.RenderConfig(engine=engine)
    leaves, tdef = jax.tree.flatten(params_of(scene))
    start = _apply_params(scene, jax.tree.unflatten(tdef, [
        jnp.asarray(x) for x in perturb([np.asarray(x) for x in leaves],
                                        np.asarray(scene.prims.ptype))]))
    px, py = _grid(res)
    key = jax.random.PRNGKey(0)
    target = render_tile(scene, px, py, cfg, key)

    def loss(p):
        img = render_tile(_apply_params(start, p), px, py, cfg, key)
        return jnp.sum((img - target) ** 2) / float(res * res)

    return (loss, params_of(start), np.asarray(target).reshape(res, res, 3),
            start)


def flat_value_and_grad(loss):
    """``loss``'s value and gradient as one flat vector (what
    torch_parity.jax_reference returns): [loss, grad leaves raveled]."""
    def fn(p):
        v, g = jax.value_and_grad(loss)(p)
        return jnp.concatenate([v[None]] + [x.ravel()
                                            for x in jax.tree.leaves(g)])
    return fn


def split_flat(flat, like):
    """(loss, [grad leaves]) of ``flat_value_and_grad``'s vector, shaped as
    the leaves ``like``."""
    out, k = [], 1
    for x in like:
        n = int(np.prod(np.shape(x)))
        out.append(np.asarray(flat[k:k + n]).reshape(np.shape(x)))
        k += n
    return float(flat[0]), out


def jax_live():
    """The live problem's [loss, gradient over the light positions
    raveled], computed by the JAX package: mount_low at LIVE_RES, depth
    LIVE_DEPTH, light 0 moved by LIVE_MOVE, the loss against a uniform 0.5
    image."""
    scene = rt.build_scene(mount_scene(res=LIVE_RES))
    cfg = rt.RenderConfig(max_depth=LIVE_DEPTH)
    px, py = _grid(LIVE_RES)

    def loss(q):
        s = dataclasses.replace(
            scene, lights=dataclasses.replace(scene.lights, position=q))
        img = render_tile(s, px, py, cfg, jax.random.PRNGKey(0))
        return jnp.sum((img - 0.5) ** 2) / float(LIVE_RES * LIVE_RES)

    def fn(q):
        v, g = jax.value_and_grad(loss)(q)
        return jnp.concatenate([v[None], g.ravel()])

    q = np.asarray(scene.lights.position).copy()
    q[0] += np.float32(LIVE_MOVE)
    return jax_reference(fn, jnp.asarray(q))


def main():
    jax.config.update("jax_platforms", "cpu")
    arrays = {}
    live = jax_live()
    arrays["live/loss"] = np.float32(live[0])
    arrays["live/grad"] = live[1:]
    pin = rt.build_scene(mount_scene(res=PIN_RES))
    for engine in ENGINES:
        arrays[f"pin/{engine}"] = jax_render_image(
            pin, rt.RenderConfig(engine=engine))
    for engine in ENGINES:
        loss, p0, target, _ = jax_problem(RES, engine)
        like = jax.tree.leaves(p0)
        value, grads = split_flat(jax_reference(flat_value_and_grad(loss),
                                                p0), like)
        arrays[f"{engine}/loss"] = np.float32(value)
        arrays[f"{engine}/target"] = target
        for i, g in enumerate(grads):
            arrays[f"{engine}/grad_{i}"] = g
        for i, x in enumerate(like):
            arrays[f"{engine}/param_{i}"] = np.asarray(x)
        print(f"{engine} {RES}x{RES}: loss {value:.6g}")
    _, _, target, start = jax_problem(RES, "sweep")
    new, step_loss = train_step_full(
        start, jnp.asarray(target), rt.RenderConfig(engine="sweep"),
        default_mesh(1), LR, jax.random.PRNGKey(0), lr_scales(geometry=1.0))
    arrays["step/loss"] = np.float32(step_loss)
    for i, x in enumerate(jax.tree.leaves(params_of(new))):
        arrays[f"step/param_{i}"] = np.asarray(x)
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez(FIXTURE, **arrays)
    print(f"wrote {FIXTURE}: {len(arrays)} arrays")


if __name__ == "__main__":
    main()
