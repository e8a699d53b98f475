"""The port's CUDA kernels against their plain versions, on the card.

Needs no JAX, so that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Without a card the tests skip.
"""
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import build_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
    Rays,
    RenderConfig,
)
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
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    mount_scene,
    sphere_field_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    render_image,
)
import chip_smoke

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
@pytest.mark.parametrize("label", [c[0] for c in chip_smoke.WHITTED_CASES])
def test_whitted_kernel_case(label):
    """chip_smoke.whitted_cases: every template depth, the pruned trees,
    each distribution flag and the sky (u8 and f32), against the plain
    version on the same rays and stream rows, under WHITTED_LIMITS."""
    dev = _cuda()
    [(_, limits, scene, cfg, draws)] = list(chip_smoke.whitted_cases(
        dev, only=label))
    before = kernels.whitted_megakernel.launches
    got = chip_smoke.whitted_run(scene, cfg, draws)
    assert kernels.whitted_megakernel.launches == before + len(draws)
    want = chip_smoke.whitted_run(scene, cfg, draws, kernel=False)
    chip_smoke.check_pt(label, got, want, limits)


@pytest.mark.cuda
def test_whitted_distribution_render_image():
    """render_image on the megakernel engine with a scene's spp, soft
    shadows, fuzzy reflection and a skybox: one launch a subpixel, and the
    sweep's image from the same generator seed."""
    import dataclasses

    dev = _cuda()
    scene = build_scene(mount_scene(res=32), device=dev)
    scene = dataclasses.replace(
        scene, spp=2, skybox=chip_smoke.synthetic_cubemap(dev),
        has_skybox=True)
    cfg = RenderConfig(engine="megakernel", soft_shadow=True,
                       fuzzy_reflection=True,
                       use_skybox=True).with_scene_flags(scene)
    before = kernels.whitted_megakernel.launches
    got = render_image(scene, cfg, torch.Generator(device=dev).manual_seed(3))
    assert kernels.whitted_megakernel.launches == before + 4
    want = render_image(scene, dataclasses.replace(cfg, engine="sweep"),
                        torch.Generator(device=dev).manual_seed(3))
    assert got.shape == (32, 32, 3) and bool(torch.isfinite(got).all())
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


def _soup(dev, n=400):
    return build_scene(chip_smoke.soup_scene(n_tri=n, n_sph=n), device=dev)


@pytest.mark.cuda
def test_bvh_kernels_match_plain_on_a_mixed_soup():
    """Closest, any (max_t 1 and unbounded, with dead lanes) and the fused
    multi-light any against the plain walk on incoherent rays through all
    four primitive types, under chip_smoke.BVH_LIMITS; the fused launch
    equals one launch per set."""
    dev = _cuda()
    tables = _soup(dev).packets
    g = torch.Generator(device=dev).manual_seed(0)
    o = torch.rand(8192, 3, device=dev, generator=g) * 16 - 8
    d = torch.nn.functional.normalize(
        torch.randn(8192, 3, device=dev, generator=g), dim=-1)
    segs = torch.rand(2, 8192, 3, device=dev, generator=g) * 16 - 8 - o
    dead = torch.rand(2, 8192, device=dev, generator=g) < 0.3
    before = [k.launches for k in (kernels.bvh_closest, kernels.bvh_any,
                                   kernels.bvh_any_multi)]
    cases = [("closest", (o, d))]
    for max_t in (1.0, 1e30):
        cases += [("any", (o, segs[0], max_t, dead[0])),
                  ("any", (o, segs[1], max_t, None)),
                  ("multi", (o, segs, max_t, dead))]
    for query, args in cases:
        got = chip_smoke.bvh_run(query, tables, args)
        want = chip_smoke.bvh_run(query, tables, args, kernel=False)
        reading = chip_smoke.hit_agreement(query, got, want)
        assert not chip_smoke.rejects(reading, chip_smoke.BVH_LIMITS), (
            query, reading)
        if query == "multi":
            assert torch.equal(got, torch.stack([
                kernels.bvh_any(tables, o, segs[i], args[2], dead[i])
                for i in range(2)]))
    after = [k.launches for k in (kernels.bvh_closest, kernels.bvh_any,
                                  kernels.bvh_any_multi)]
    assert [a - b for a, b in zip(after, before)] == [1, 8, 2]


@pytest.mark.cuda
def test_bvh_render_matches_brute_force_on_the_card():
    dev = _cuda()
    scene = build_scene(sphere_field_scene(n_side=16, res=32), device=dev)
    before = kernels.bvh_closest.launches
    got = render_image(scene, RenderConfig())
    assert kernels.bvh_closest.launches > before
    want = render_image(scene, RenderConfig(accel_impl="brute"))
    assert got.shape == (32, 32, 3) and bool(torch.isfinite(got).all())
    assert _bad_fraction(got, want) <= MAX_BAD


@pytest.mark.cuda
def test_bvh_kernels_reject_grad_and_cpu_tensors():
    dev = _cuda()
    tables = _soup(dev, n=8).packets
    o = torch.zeros(4, 3, device=dev, requires_grad=True)
    d = torch.ones(4, 3, device=dev)
    with pytest.raises(NotImplementedError):
        kernels.bvh_closest(tables, o, d)
    with pytest.raises(NotImplementedError):
        kernels.bvh_any(tables, o, d, 1.0)
    with pytest.raises(ValueError):
        kernels.bvh_closest(tables, o.detach().cpu(), d.cpu())
    with pytest.raises(ValueError):
        kernels.bvh_any(tables, o.detach(), d.cpu(), 1.0)
    with pytest.raises(ValueError):
        kernels.bvh_any_multi(tables, o.detach(), d[None], 1.0,
                              torch.zeros(1, 4, dtype=torch.bool))


@pytest.mark.cuda
def test_brute_kernels_match_plain_on_a_mixed_soup():
    """Closest and any hit (max_t 1 and unbounded, with and without dead
    lanes) over the soup's triangles alone, spheres alone and both tables
    against the plain version, under chip_smoke.BRUTE_LIMITS; a render of
    the whole soup (planes and the box folded after the kernels) against
    the BVH walk's; the counters' instantiation answers the same and
    records every test of a closest hit at one of its stages."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    dev = _cuda()
    soup = _soup(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    o = torch.rand(8192, 3, device=dev, generator=g) * 16 - 8
    d = torch.nn.functional.normalize(
        torch.randn(8192, 3, device=dev, generator=g), dim=-1)
    segs = torch.rand(8192, 3, device=dev, generator=g) * 16 - 8 - o
    dead = torch.rand(8192, device=dev, generator=g) < 0.3
    before = [k.launches for k in (kernels.brute_closest, kernels.brute_any)]
    for tri, sph in ((True, False), (False, True), (True, True)):
        prims = chip_smoke.subset(soup.prims, tri, sph)
        tables = intersect.brute_tables(prims)
        cases = [("closest", (o, d))] + [
            ("any", (o, segs, max_t, dd)) for max_t in (1.0, C.BIG)
            for dd in (dead, None)]
        for query, args in cases:
            got = chip_smoke.brute_run(query, tables, args)
            want = chip_smoke.brute_plain(query, prims, args)
            reading = chip_smoke.hit_agreement(query, got, want)
            assert not chip_smoke.rejects(reading, chip_smoke.BRUTE_LIMITS), (
                tri, sph, query, reading)
    after = [k.launches for k in (kernels.brute_closest, kernels.brute_any)]
    assert [a - b for a, b in zip(after, before)] == [3, 12]
    sd = chip_smoke.soup_scene(n_tri=400, n_sph=400, res=32)
    brute = build_scene(sd, device=dev, accel=C.ACCEL_NONE)
    got = render_image(brute, RenderConfig())
    assert kernels.brute_closest.launches == after[0] + 4
    want = render_image(build_scene(sd, device=dev), RenderConfig())
    assert got.shape == (32, 32, 3) and bool(torch.isfinite(got).all())
    assert _bad_fraction(got, want) <= MAX_BAD
    tables = brute.brute
    counts = torch.zeros((8192, kernels.BRUTE_COUNTS), dtype=torch.int32,
                         device=dev)
    counted = kernels.brute_closest(tables, o, d, counts=counts)
    plain = kernels.brute_closest(tables, o, d)
    assert all(torch.equal(a, b) for a, b in zip(counted, plain))
    assert bool((counts[:, :4].sum(dim=1) == tables.n_tri).all())
    assert bool((counts[:, 4:].sum(dim=1) == tables.n_sph).all())


@pytest.mark.cuda
def test_brute_kernels_reject_grad_and_cpu_tensors():
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    dev = _cuda()
    tables = intersect.brute_tables(_soup(dev, n=8).prims)
    o = torch.zeros(4, 3, device=dev, requires_grad=True)
    d = torch.ones(4, 3, device=dev)
    with pytest.raises(NotImplementedError):
        kernels.brute_closest(tables, o, d)
    with pytest.raises(NotImplementedError):
        kernels.brute_any(tables, o, d, 1.0)
    with pytest.raises(ValueError):
        kernels.brute_closest(tables, o.detach().cpu(), d.cpu())
    with pytest.raises(ValueError):
        kernels.brute_any(tables, o.detach(), d.cpu(), 1.0)
    with pytest.raises(ValueError):
        kernels.brute_any(tables, o.detach(), d, 1.0,
                          torch.zeros(4, dtype=torch.bool))
    # the dispatch launches only on the scene's packed tables
    soup = _soup(dev)
    with pytest.raises(ValueError, match="Scene.brute"):
        intersect.closest_hit_brute(soup.prims, Rays.make(o.detach(), d))


@pytest.mark.cuda
@pytest.mark.parametrize("op", kernels.PROBE_OPS)
def test_op_rate_kernel_matches_plain(op):
    """T1 at 2^16 elements under tools/roofline_mount.RTOL."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        roofline_mount as rm,
    )

    x = rm.op_rate_input(1 << 16, _cuda())
    assert rm.rel_err(kernels.op_rate(x, op), rm.op_rate_plain(x, op)) \
        <= rm.RTOL[op]


@pytest.mark.cuda
def test_fma_peak_kernel_matches_plain():
    """T2 at the JAX tool's [64 x 256, 128] under
    tools/device_validate.RTOL."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        device_validate as dv,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        roofline_mount as rm,
    )

    x = dv.fma_peak_input(64, _cuda())
    assert rm.rel_err(kernels.fma_peak(x), dv.fma_peak_plain(x)) <= dv.RTOL


@pytest.mark.cuda
def test_stack_walk_kernel_equals_plain_and_oracle():
    """T3, both stack placements, the probe's tree and a deep tree:
    exactly."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        probe_features as pf,
    )

    dev = _cuda()
    before = kernels.stack_walk.launches
    pf.check_walks(dev)
    assert kernels.stack_walk.launches == before + 4


@pytest.mark.cuda
def test_probe_kernels_reject_grad_and_cpu_tensors():
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import (
        probe_features as pf,
    )

    dev = _cuda()
    x = torch.ones(256, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError):
        kernels.op_rate(x, "fma")
    with pytest.raises(NotImplementedError):
        kernels.fma_peak(x)
    with pytest.raises(ValueError):
        kernels.op_rate(x.detach(), "fma", k=500)   # not a multiple of 16
    nbox, nmeta, table, rays = (torch.from_numpy(a).to(dev)
                                for a in pf.probe_tree())
    with pytest.raises(ValueError):
        kernels.stack_walk(nbox, nmeta.cpu(), table, rays)
    with pytest.raises(NotImplementedError):
        kernels.stack_walk(nbox, nmeta, table, rays.requires_grad_())
