"""The port's CUDA kernel against its plain version, on the card.

Needs no JAX, so that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Without a card the tests skip.
"""
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import build_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import RenderConfig
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_megakernel as mk,
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
