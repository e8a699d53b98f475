"""Finite differences of the port's renders and of the NumPy oracle against
the port's autograd: the cases of tests/test_gradients.py,
tests/test_fit_params.py and tests/test_oracle_fd.py, at their tolerances.

The port differentiates its own renderer (central differences of the
port's loss) over materials, light colours and positions, ior and the
camera's eye; and against ``tests/oracle.py`` (the independent scalar
renderer of the reference semantics, which needs no JAX), over material
and geometry parameters: where the two renderers agree on a neighbourhood,
their derivatives agree. The wavefront's gradient equals the sweep's
(tests/test_gradients.py:123).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
    build_scene,
    with_prim_params,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import RenderConfig
from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import SceneDef
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    render_image,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
from oracle import Oracle
from torch_parity import mixed_scene, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def sphere_plane_scene(res):
    """tests/test_whitted_vs_oracle.py::sphere_plane_scene on the port's
    SceneDef."""
    sd = SceneDef()
    sd.set_camera(eye=[0, 1, 5], at=[0, 0, 0], up=[0, 1, 0], fov=45,
                  hither=0.01, res_x=res, res_y=res, aperture_ratio=0,
                  focal_ratio=1)
    m0 = sd.add_material([0.8, 0.2, 0.2], 0.9, [1, 1, 1], 0.1, 30, 0, 1)
    sd.add_sphere([0, 0, 0], 1.0, m0)
    m1 = sd.add_material([0.4, 0.4, 0.9], 1.0, [1, 1, 1], 0.0, 10, 0, 1)
    sd.add_plane_points([0, -1, 0], [1, -1, 0], [0, -1, -1], m1)
    sd.add_light([5, 5, 5], [1, 1, 1])
    sd.add_light([-4, 6, 2], [0.4, 0.4, 0.6])
    sd.bg_color = np.array([0.1, 0.2, 0.3], np.float32)
    return sd


def mixed(res):
    return mixed_scene(SceneDef(), res=res)


def _with_field(scene, field, value):
    """``scene`` with a material field or ``light_color`` replaced."""
    if field == "light_color":
        return dataclasses.replace(scene, lights=dataclasses.replace(
            scene.lights, color=value))
    return dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, **{field: value}))


def _base(scene, field):
    if field == "light_color":
        return scene.lights.color
    return getattr(scene.materials, field)


def _grad(loss, leaf):
    """d loss / d leaf; zeros where the loss does not depend on the leaf
    differentiably (transmit only gates the refraction child, as in JAX,
    whose gradient there is 0)."""
    if not loss.requires_grad:
        return torch.zeros_like(leaf)
    (g,) = torch.autograd.grad(loss, leaf, allow_unused=True)
    return torch.zeros_like(leaf) if g is None else g


def _fd_check(scene, cfg, coords, eps=2e-3, rtol=0.08, atol=2e-4,
              loss=lambda img: (img ** 2).mean()):
    """tests/test_gradients.py::_fd_check on the port: autograd against
    central differences of ``loss`` at the coordinates (field, index)."""
    for field, idx in coords:
        base = _base(scene, field)
        leaf = base.detach().clone().requires_grad_()
        g = _grad(loss(render_image(_with_field(scene, field, leaf), cfg)),
                  leaf)
        analytic = float(g[idx])

        def at(delta):
            v = base.detach().clone()
            v[idx] += delta
            return float(loss(render_image(_with_field(scene, field, v),
                                           cfg)))

        fd = (at(eps) - at(-eps)) / (2 * eps)
        assert np.isfinite(fd) and np.isfinite(analytic)
        tol = atol + rtol * max(abs(fd), abs(analytic))
        assert abs(fd - analytic) <= tol, (
            f"{field}{idx}: autograd {analytic:.6g} vs FD {fd:.6g}")


def test_fd_gradients_sphere_plane():
    scene = build_scene(sphere_plane_scene(12), device=CPU)
    _fd_check(scene, RenderConfig(), [
        ("diff_color", (0, 0)), ("diff_color", (1, 2)), ("kd", (0,)),
        ("ks", (0,)), ("spec_color", (0, 1)), ("light_color", (0, 0)),
        ("light_color", (1, 2))])


def test_fd_gradients_reflective_refractive():
    """Through the reflection and refraction subtrees (a mirror and a glass
    sphere): transmit and shine too."""
    scene = build_scene(mixed(12), device=CPU)
    _fd_check(scene, RenderConfig(), [
        ("diff_color", (0, 0)), ("ks", (1,)), ("spec_color", (1, 0)),
        ("transmit", (2,)), ("shine", (1,))], eps=4e-3, rtol=0.12)


def test_fd_gradient_ior():
    """ior bends refracted rays, so the loss is piecewise smooth; the step
    stays inside the segment (tests/test_gradients.py:97-107)."""
    scene = build_scene(mixed(10), device=CPU)
    _fd_check(scene, RenderConfig(refraction_mode="physical"),
              [("ior", (2,))], eps=1e-3, rtol=0.15)


def test_fd_gradient_light_position():
    scene = build_scene(sphere_plane_scene(12), device=CPU)
    cfg = RenderConfig()

    def loss_at(pos):
        s = dataclasses.replace(scene, lights=dataclasses.replace(
            scene.lights, position=pos))
        return (render_image(s, cfg) ** 2).mean()

    base = scene.lights.position
    leaf = base.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss_at(leaf), leaf)
    eps = 2e-2
    for idx in [(0, 0), (0, 1), (0, 2)]:
        up, down = base.clone(), base.clone()
        up[idx] += eps
        down[idx] -= eps
        fd = (float(loss_at(up)) - float(loss_at(down))) / (2 * eps)
        analytic = float(g[idx])
        tol = 2e-4 + 0.08 * max(abs(fd), abs(analytic))
        assert abs(fd - analytic) <= tol, (idx, analytic, fd)


def test_fd_gradient_camera_eye():
    """The eye through with_eye (SetEye): finite, and equal to FD on a
    smooth segment."""
    scene = build_scene(sphere_plane_scene(10), device=CPU)
    cfg = RenderConfig()

    def loss_at(eye):
        p = dataclasses.replace(dist.params_of(scene), cam_eye=eye)
        return (render_image(dist._apply_params(scene, p), cfg) ** 2).mean()

    base = scene.camera.eye
    leaf = base.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss_at(leaf), leaf)
    assert bool(torch.isfinite(g).all())
    eps = 1e-3
    up, down = base.clone(), base.clone()
    up[2] += eps
    down[2] -= eps
    fd = (float(loss_at(up)) - float(loss_at(down))) / (2 * eps)
    tol = 5e-4 + 0.15 * max(abs(fd), abs(float(g[2])))
    assert abs(fd - float(g[2])) <= tol, (float(g[2]), fd)


def test_wavefront_gradients_match_sweep():
    """The wavefront's value and gradient over the whole FitParams equal
    the sweep's (tests/test_gradients.py:123, mount_low at 20x20)."""
    scene = build_scene(mount_scene(res=20), device=CPU)
    out = {}
    for engine in ("sweep", "wavefront"):
        p0 = dist._leaf_params(dist.params_of(scene))
        img = render_image(dist._apply_params(scene, p0),
                           RenderConfig(engine=engine))
        loss = (img ** 2).mean()
        leaves = dist.tree_leaves(p0)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[engine] = (float(loss.detach()), [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
    (ls, gs), (lw, gw) = out["sweep"], out["wavefront"]
    assert abs(ls - lw) < 1e-5
    for a, b in zip(gs, gw):
        scale = float(a.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 5e-3 * scale + 1e-6


# ---------------------------------------------------------------------------
# against the NumPy oracle (tests/test_oracle_fd.py)

RES = 10
# material row layout in a SceneDef: [diff(3), kd, spec(3), ks, shine, T, ior]
_COL = {"diff_color": 0, "kd": 3, "spec_color": 4, "ks": 7}


def _oracle_loss(sd, cfg):
    return float(np.mean(Oracle(sd, cfg).render()))


def _oracle_fd(sd, cfg, mat_idx, col, eps):
    def at(delta):
        sd2 = copy.deepcopy(sd)
        sd2.materials[mat_idx] = sd2.materials[mat_idx].copy()
        sd2.materials[mat_idx][col] += delta
        return _oracle_loss(sd2, cfg)

    return (at(eps) - at(-eps)) / (2 * eps)


def _port_grad(scene, cfg, field, idx):
    leaf = getattr(scene.materials, field).clone().requires_grad_()
    img = render_image(_with_field(scene, field, leaf), cfg)
    (g,) = torch.autograd.grad(img.mean(), leaf)
    return float(g[idx])


def _check(sd, cfg, cases, eps=2e-3, rtol=0.10, atol=3e-4):
    scene = build_scene(sd, device=CPU)
    for field, mat_idx, comp in cases:
        fd = _oracle_fd(sd, cfg, mat_idx, _COL[field] + comp, eps)
        idx = ((mat_idx, comp) if field in ("diff_color", "spec_color")
               else (mat_idx,))
        analytic = _port_grad(scene, cfg, field, idx)
        assert np.isfinite(fd) and np.isfinite(analytic)
        tol = atol + rtol * max(abs(fd), abs(analytic))
        assert abs(fd - analytic) <= tol, (
            f"{field}[{mat_idx},{comp}]: autograd {analytic:.6g} vs "
            f"oracle FD {fd:.6g}")


def test_oracle_fd_sphere_plane():
    _check(sphere_plane_scene(RES), RenderConfig(), [
        ("diff_color", 0, 0), ("diff_color", 1, 2), ("kd", 0, 0),
        ("ks", 0, 0)])


def test_oracle_fd_through_secondary_rays():
    _check(mixed(RES), RenderConfig(), [
        ("diff_color", 0, 0), ("ks", 1, 0), ("spec_color", 1, 0)],
        eps=4e-3, rtol=0.12)


def _tri_renormal(p):
    """The stored flat normal re-derived after an edge moves, as
    with_prim_params and the reference's constructor do."""
    n = np.cross(p[3:6], p[6:9])
    nn = np.linalg.norm(n)
    p[9:12] = n / nn if nn > 0 else 0.0
    return p


def _oracle_fd_geom(sd, cfg, obj_idx, col, eps):
    def at(delta):
        sd2 = copy.deepcopy(sd)
        p = sd2.objects[obj_idx].params.astype(np.float64).copy()
        p[col] += delta
        if sd2.objects[obj_idx].ptype == 1:  # TRIANGLE
            p = _tri_renormal(p)
        sd2.objects[obj_idx].params = p.astype(np.float32)
        return _oracle_loss(sd2, cfg)

    return (at(eps) - at(-eps)) / (2 * eps)


def _port_grad_geom(scene, cfg, obj_idx, col):
    leaf = scene.prims.params.clone().requires_grad_()
    img = render_image(with_prim_params(scene, leaf), cfg)
    (g,) = torch.autograd.grad(img.mean(), leaf)
    return float(g[obj_idx, col])


@pytest.mark.parametrize("case", [
    ("sphere_plane", [(0, 0), (0, 2), (0, 3)], 1e-3),
    ("mixed triangle vertex", [(3, 0), (3, 4)], 2e-3),
    ("mixed mirror sphere", [(1, 0), (1, 3)], 2e-3)],
    ids=["sphere", "triangle_vertex", "sphere_secondary"])
def test_oracle_fd_geometry(case):
    """Sphere centre and radius, a triangle's v0 and an e1 component (the
    normal re-derived on both sides), the mirror sphere's centre through
    the reflection subtree: autograd through with_prim_params against the
    oracle's central differences (tests/test_oracle_fd.py:154-179)."""
    name, cases, eps = case
    sd = sphere_plane_scene(RES) if name == "sphere_plane" else mixed(RES)
    cfg = RenderConfig()
    scene = build_scene(sd, device=CPU)
    for obj_idx, col in cases:
        fd = _oracle_fd_geom(sd, cfg, obj_idx, col, eps)
        analytic = _port_grad_geom(scene, cfg, obj_idx, col)
        assert np.isfinite(fd) and np.isfinite(analytic)
        tol = 5e-4 + 0.15 * max(abs(fd), abs(analytic))
        assert abs(fd - analytic) <= tol, (
            f"geom obj {obj_idx} col {col}: autograd {analytic:.6g} vs "
            f"oracle FD {fd:.6g}")
