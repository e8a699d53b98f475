"""The port's CUDA kernels against their plain versions, on the card.

Needs no JAX, so that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Without a card the tests skip.
"""
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import build_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import RenderConfig
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import pathtracer as pt
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    pt_megakernel as ptk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_megakernel as mk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene import (
    glsl_camera,
    glsl_world,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import mount_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    render_image,
)

ATOL = 2e-3       # tests/conftest.assert_images_close
MAX_BAD = 0.01


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bad_fraction(got, want):
    diff = (got.double() - want.double()).abs().amax(dim=-1)
    return float((diff > ATOL).double().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("fresnel", ["schlick", "reference_schlick",
                                     "reference_exact"])
def test_kernel_matches_plain_mount64_depth4(fresnel):
    dev = _cuda()
    scene = build_scene(mount_scene(res=64), device=dev)
    cfg_mk = RenderConfig(engine="megakernel", fresnel_mode=fresnel)
    before = kernels.whitted_megakernel.launches
    got = render_image(scene, cfg_mk)
    assert kernels.whitted_megakernel.launches == before + 1
    want = render_image(scene, RenderConfig(fresnel_mode=fresnel))
    assert got.shape == (64, 64, 3) and bool(torch.isfinite(got).all())
    assert _bad_fraction(got, want) <= MAX_BAD


@pytest.mark.cuda
def test_kernel_rejects_grad_and_cpu_tensors():
    dev = _cuda()
    scene = build_scene(mount_scene(res=8), device=dev)
    tbl, lt, bg = mk.scene_tables(scene)
    o = torch.zeros(4, 3, device=dev, requires_grad=True)
    d = torch.zeros(4, 3, device=dev)
    with pytest.raises(NotImplementedError):
        kernels.whitted_megakernel(tbl, lt, bg, o, d, mk.shape_of(scene),
                                   RenderConfig())
    with pytest.raises(ValueError):
        kernels.whitted_megakernel(tbl.cpu(), lt, bg, o.detach(), d,
                                   mk.shape_of(scene), RenderConfig())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    pt.PTConfig(),
    pt.PTConfig(max_bounces=4, russian_roulette=True),
    pt.PTConfig(max_bounces=2, reference_shadow_len1=True)],
    ids=["base", "rr", "len1"])
def test_pt_kernel_matches_plain_glsl32(cfg):
    """The path tracer's image rule: at most 2% of pixels beyond 2e-3 and a
    mean abs difference <= 1e-4 (tests/test_pt_megakernel.py:83-93)."""
    dev = _cuda()
    world = glsl_world(device=dev, showcase_fuzzy_reflections=True,
                       showcase_fuzzy_refractions=True)
    cam = glsl_camera(32, 32, device=dev)
    before = kernels.pt_megakernel.launches
    got = ptk.make_render_frame(world, cam, cfg, "megakernel")(
        torch.Generator(device=dev).manual_seed(4))
    assert kernels.pt_megakernel.launches == before + 1
    want = ptk.make_render_frame(world, cam, cfg, "plain")(
        torch.Generator(device=dev).manual_seed(4))
    assert got.shape == (32, 32, 3) and bool(torch.isfinite(got).all())
    diff = (got.double() - want.double()).abs()
    assert float((diff.amax(dim=-1) > ATOL).double().mean()) <= 0.02
    assert float(diff.mean()) <= 1e-4


@pytest.mark.cuda
def test_pt_kernel_rejects_grad_and_cpu_tensors():
    dev = _cuda()
    tables = ptk.pt_tables(glsl_world(device=dev))
    o = torch.zeros(4, 3, device=dev, requires_grad=True)
    d = torch.zeros(4, 3, device=dev)
    tm = torch.zeros(4, device=dev)
    uni = torch.zeros(1, pt.N_UNIFORMS, 4, device=dev)
    with pytest.raises(NotImplementedError):
        kernels.pt_megakernel(tables, o, d, tm, uni, pt.PTConfig())
    with pytest.raises(ValueError):
        kernels.pt_megakernel(tables, o.detach(), d, tm.cpu(), uni,
                              pt.PTConfig())
    with pytest.raises(ValueError):
        kernels.pt_megakernel(tables, o.detach().cpu(), d.cpu(), tm.cpu(),
                              uni.cpu(), pt.PTConfig())
