"""The port's inverse rendering (parallel/dist.py, core/build
.with_prim_params, ops/camera.with_eye, the Whitted kernel's
autograd.Function) against the JAX package's ``value_and_grad`` and
``train_step_full`` on mount_low at 16x16, depth 4.

The JAX references are in tests/fixtures/mount_jax_refs.npz, written by
tests/make_grad_fixture.py (one JAX gradient of the whole FitParams takes
30-60 s to compile on an 8-core x86 host); the live test recomputes its
small live problem with JAX, so the fixture stays the JAX package's answer.

Tolerance: JAX's own for gradients that two engines compute
(tests/test_gradients.py:151-154), max |a - b| <= 5e-3 * max |a| + 1e-6 per
group, the triangle vertices held on their own; losses to 1e-5 relative
(a sum of 768 f32 squares in another order: JAX shards the step's loss).
The Function on CPU tensors (the plain version as its forward) equals
autograd through the plain version exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import build_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
    RenderConfig,
    Rays,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_megakernel as mk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.samples import (
    draw_subpixel,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    pixel_grid,
    render_image,
    scene_layout,
    subpixel_rays,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
from make_grad_fixture import (
    FIXTURE,
    LIVE_DEPTH,
    LIVE_MOVE,
    LIVE_RES,
    LR,
    N_LEAVES,
    RES,
    jax_live,
    perturb,
)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
REFS = np.load(FIXTURE)
# FitParams leaves by group, in the flatten order (dist.tree_leaves)
GROUPS = {"materials": range(0, 7), "lights": (7, 8), "camera": (9, 10),
          "spheres": (11,), "triangles": (11,)}


def close(got, want, what):
    """JAX's gradient tolerance: max |a - b| <= 5e-3 max |a| + 1e-6."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max(initial=0.0)
    lim = 5e-3 * np.abs(want).max(initial=0.0) + 1e-6
    assert err <= lim, f"{what}: max abs err {err:.3g} over {lim:.3g}"


def start_scene():
    """The port's perturbed mount_low at RES (make_grad_fixture.perturb)."""
    scene = build_scene(mount_scene(res=RES), device=CPU)
    leaves = [x.numpy() for x in dist.tree_leaves(dist.params_of(scene))]
    new = perturb(leaves, scene.prims.ptype.numpy())
    return dist._apply_params(
        scene, dist.tree_unflatten(torch.from_numpy(x) for x in new))


def rows_of(leaf, group, ptype):
    """The part of a leaf a group holds: the table's sphere rows, or its
    triangle rows' vertex columns (the normal is derived)."""
    if group == "spheres":
        return leaf[ptype == C.SPHERE, :4]
    if group == "triangles":
        return leaf[ptype == C.TRIANGLE, :9]
    return leaf


def ref_of(engine):
    """The fixture's engine for a port engine: the megakernel engine on
    CPU tensors is the plain version, held to JAX's sweep."""
    return "wavefront" if engine == "wavefront" else "sweep"


@functools.cache
def port_value_and_grad(engine):
    """The port's loss and FitParams gradient (NumPy leaves) at the
    perturbed scene against JAX's target, on ``engine``."""
    target = torch.from_numpy(REFS[f"{ref_of(engine)}/target"])
    loss, grads = dist.value_and_grad(start_scene(), target,
                                      RenderConfig(engine=engine))
    return float(loss), [g.numpy() for g in dist.tree_leaves(grads)]


def test_live_jax_holds_the_fixture():
    """JAX recomputes the fixture's live problem (light positions'
    gradient, mount_low 8x8, depth 1); the port's equals it."""
    live = jax_live()
    np.testing.assert_allclose(live[0], REFS["live/loss"], rtol=1e-6)
    np.testing.assert_allclose(live[1:], REFS["live/grad"], rtol=1e-5,
                               atol=1e-9)
    scene = build_scene(mount_scene(res=LIVE_RES), device=CPU)
    q = scene.lights.position.clone()
    q[0] += torch.tensor(LIVE_MOVE)
    q.requires_grad_()
    s = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, position=q))
    img = render_image(s, RenderConfig(max_depth=LIVE_DEPTH))
    loss = ((img - 0.5) ** 2).sum() / float(LIVE_RES * LIVE_RES)
    (g,) = torch.autograd.grad(loss, q)
    np.testing.assert_allclose(float(loss.detach()), REFS["live/loss"],
                               rtol=1e-5)
    close(g.numpy().ravel(), REFS["live/grad"], "live light positions")


def test_start_matches_jax():
    """The perturbed scene's leaves, through with_eye and with_prim_params
    (the triangle's normal re-derived), equal JAX's."""
    start = start_scene()
    for i, leaf in enumerate(dist.tree_leaves(dist.params_of(start))):
        np.testing.assert_allclose(leaf.numpy(), REFS[f"sweep/param_{i}"],
                                   rtol=0, atol=2e-6, err_msg=f"leaf {i}")
    for f in ("u", "v", "n"):
        assert np.isfinite(getattr(start.camera, f).numpy()).all()


@pytest.mark.parametrize("engine", ["sweep", "wavefront", "megakernel"])
def test_loss_matches_jax(engine):
    value, _ = port_value_and_grad(engine)
    np.testing.assert_allclose(value, REFS[f"{ref_of(engine)}/loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("engine", ["sweep", "wavefront", "megakernel"])
def test_group_gradient_matches_jax(engine, group):
    """Each FitParams group's gradient against JAX's on the same engine
    (``ref_of``)."""
    ref = ref_of(engine)
    _, grads = port_value_and_grad(engine)
    ptype = build_scene(mount_scene(res=RES), device=CPU).prims.ptype.numpy()
    for i in GROUPS[group]:
        want = rows_of(REFS[f"{ref}/grad_{i}"], group, ptype)
        assert group == "camera" or np.abs(want).max() > 0 or i == 5, i
        close(rows_of(grads[i], group, ptype), want, f"{group} leaf {i}")


def test_triangle_normal_gradient_reaches_the_vertices():
    """The normal columns are derived, not leaves: their gradient is 0
    and the vertices carry it (the 8.62 mismatch of free normals)."""
    _, grads = port_value_and_grad("sweep")
    ptype = build_scene(mount_scene(res=RES), device=CPU).prims.ptype.numpy()
    tri = grads[11][ptype == C.TRIANGLE]
    assert np.abs(tri[:, 9:12]).max() == 0.0
    assert np.abs(tri[:, :9]).max() > 0.0


def test_train_step_full_matches_jax():
    """One train_step_full (sweep, lr LR, every scale 1 with the
    geometry) from the perturbed scene: the loss and every leaf after the
    update, each held to JAX's update by the gradient tolerance."""
    start = start_scene()
    new, loss = dist.train_step_full(
        start, torch.from_numpy(REFS["sweep/target"]),
        RenderConfig(engine="sweep"), LR, None,
        dist.lr_scales(geometry=1.0))
    assert loss.shape == () and not loss.requires_grad
    np.testing.assert_allclose(float(loss), REFS["step/loss"], rtol=1e-5)
    for i, leaf in enumerate(dist.tree_leaves(dist.params_of(new))):
        before = REFS[f"sweep/param_{i}"]
        want = REFS[f"step/param_{i}"]
        close(leaf.numpy() - before, want - before, f"update of leaf {i}")
    assert len(dist.tree_leaves(dist.params_of(new))) == N_LEAVES


@pytest.mark.parametrize("plan", ["deterministic", "distribution"])
def test_function_equals_plain_autograd(plan):
    """WhittedTrace on CPU tensors (the plain version as its forward)
    against autograd straight through trace_rays_plain, with the same
    stream rows: the forward bit for bit, every gradient exactly."""
    cfg = RenderConfig(engine="megakernel")
    if plan == "distribution":
        cfg = dataclasses.replace(cfg, anti_aliasing=True, spp=2,
                                  soft_shadow=True, fuzzy_reflection=True)
    scene = start_scene()
    px, py = pixel_grid(RES, RES, CPU)
    layout = scene_layout(scene, cfg)
    s = draw_subpixel(torch.Generator().manual_seed(5), layout, cfg,
                      px.shape[0], (1, 0) if cfg.anti_aliasing else None)
    rays = subpixel_rays(scene, px, py, cfg, s)
    shape = mk.shape_of(scene)
    ins = [t.detach().clone().requires_grad_()
           for t in (*mk._pack_tables(scene), rays.origin, rays.direction)]
    ct = torch.rand(px.shape[0], 3, generator=torch.Generator().manual_seed(1))
    ij = s.ij
    got = mk.WhittedTrace.apply(*ins, shape, cfg, s.rows, None, ij)
    g_fn = torch.autograd.grad(got, ins, ct, allow_unused=True)
    want = mk.trace_rays_plain(shape, *ins, cfg, s.rows, None, ij)
    g_plain = torch.autograd.grad(want, ins, ct, allow_unused=True)
    assert torch.equal(got, want.detach())
    for name, x, a, b in zip(("tbl", "lt", "bg", "o", "d"), ins, g_fn,
                             g_plain):
        a = torch.zeros_like(x) if a is None else a
        b = torch.zeros_like(x) if b is None else b
        assert torch.equal(a, b), name
    assert all(bool(g.abs().max() > 0) for g in g_fn[3:])


def test_tables_that_require_grad_are_not_cached():
    """scene_tables packs a grad-carrying scene anew each call, so two
    renders of one such scene each backward through their own graph."""
    start = start_scene()
    p0 = dist._leaf_params(dist.params_of(start))
    s = dist._apply_params(start, p0)
    cfg = RenderConfig(engine="megakernel", max_depth=2)
    grads = []
    for _ in range(2):
        img = render_image(s, cfg)
        grads.append(torch.autograd.grad(img.sum(), p0.light_pos)[0])
    assert "megakernel_tables" not in s.cache
    assert torch.equal(grads[0], grads[1]) and bool(grads[0].abs().max() > 0)
    plain = build_scene(mount_scene(res=8), device=CPU)
    mk.scene_tables(plain)
    assert "megakernel_tables" in plain.cache
    r = Rays.make(torch.zeros(4, 3), torch.tensor([[0.0, 0.0, 1.0]] * 4))
    assert r.detach().origin.requires_grad is False
