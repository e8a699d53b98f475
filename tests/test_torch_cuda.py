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
    render_image(scene, cfg_mk)  # the frame's capture (utils/graphs.py)
    got, n = chip_smoke.replay_launches(lambda: render_image(scene, cfg_mk),
                                        (kernels.whitted_megakernel,))
    assert n == {"whitted_megakernel": 1}
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


# ray counts at the edges of a block and of a warp: one ray, a warp short
# of 32 and one past it, and 4,097 (32 blocks and one ray); depth 4 is the
# main path's template, 1-8 every template
_RAY_COUNTS = ([(4, n) for n in (1, 31, 33, 4097)]
               + [(depth, 4097) for depth in (1, 2, 3, 5, 6, 7, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("depth,n", _RAY_COUNTS)
def test_whitted_kernel_ray_counts_and_depths(depth, n):
    """The kernel against its plain version on the first n rays of the
    four-type scene (every primitive type, both branches, two lights) at
    128x128, under WHITTED_LIMITS["exact"]."""
    dev = _cuda()
    scene = build_scene(chip_smoke.four_type_scene(128), device=dev)
    cfg = RenderConfig(engine="megakernel", max_depth=depth)
    cam = scene.camera
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        pinhole_rays,
    )

    px, py = pixel_grid(cam.res_x, cam.res_y, dev)
    r = pinhole_rays(cam, px + 0.5, py + 0.5)
    o, d = r.origin[:n].contiguous(), r.direction[:n].contiguous()
    shape, (tbl, lt, bg) = mk.shape_of(scene), mk.scene_tables(scene)
    got = kernels.whitted_megakernel(tbl, lt, bg, o, d, shape, cfg)
    want = mk.trace_rays_plain(shape, tbl, lt, bg, o, d, cfg)
    assert got.shape == (n, 3)
    chip_smoke.check_pt(f"depth {depth}, {n} rays", got, want,
                        chip_smoke.WHITTED_LIMITS["exact"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_pt_kernel_ray_counts(n):
    """The path tracer's kernel against its plain version on the first n
    paths of a 128x128 frame of the seven-sphere world (3 bounces), under
    PT_LIMITS["tiny"]."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_camera,
    )

    dev = _cuda()
    cam = chip_smoke.pt_time_span(build_camera(dict(
        eye=[0.0, 2.0, 6.0], at=[0, 0.5, -1], up=[0, 1, 0], fov=60.0,
        hither=0.01, res_x=128, res_y=128, aperture_ratio=0.0,
        focal_ratio=1.0), device=dev))
    cfg = pt.PTConfig(max_bounces=3)
    tables = ptk.pt_tables(chip_smoke.tiny_pt_world(dev))
    o, d, tm, uni = chip_smoke.pt_inputs(cam, cfg, 10, dev)
    args = (o[:n].contiguous(), d[:n].contiguous(), tm[:n].contiguous(),
            uni[:, :, :n].contiguous())
    got = kernels.pt_megakernel(tables, *args, cfg)
    want = ptk.trace_rays_plain(tables, *args, cfg)
    assert got.shape == (n, 3)
    chip_smoke.check_pt(f"seven-sphere world, {n} paths", got, want,
                        chip_smoke.PT_LIMITS["tiny"])


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
    render_image(scene, cfg, torch.Generator(device=dev).manual_seed(9))
    got, n = chip_smoke.replay_launches(lambda: render_image(
        scene, cfg, torch.Generator(device=dev).manual_seed(3)),
        (kernels.whitted_megakernel,))
    assert n == {"whitted_megakernel": 4}
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
    frame = ptk.make_render_frame(world, cam, cfg, "megakernel")
    frame(torch.Generator(device=dev).manual_seed(9))  # the capture
    got, n = chip_smoke.replay_launches(
        lambda: frame(torch.Generator(device=dev).manual_seed(4)),
        (kernels.pt_megakernel,))
    assert n == {"pt_megakernel": 1}
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
def test_bvh_kernels_trace_only_live_slots():
    """Masked walk queries on the card (csrc/bvh_walk.cu packs the live
    slots inside its launch) on the mixed soup: with 0, 1, 31, 33, 4,097
    and all 8,192 slots live, and the fused query with its own mask for
    each set, the live slots read the unmasked launch's answer bit for bit
    and the plain walk's under chip_smoke.BVH_LIMITS, and the dead slots
    exactly (BIG, -1), or occluded, in outputs poisoned before the
    launch."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C

    dev = _cuda()
    tables = _soup(dev).packets
    g = torch.Generator(device=dev).manual_seed(1)
    o = torch.rand(8192, 3, device=dev, generator=g) * 16 - 8
    d = torch.nn.functional.normalize(
        torch.randn(8192, 3, device=dev, generator=g), dim=-1)
    segs = torch.rand(2, 8192, 3, device=dev, generator=g) * 16 - 8 - o
    full = kernels.bvh_closest(tables, o, d)
    full_occ = kernels.bvh_any_multi(tables, o, segs, 1.0)
    for n_live in (0, 1, 31, 33, 4097, 8192):
        dead = torch.ones(2, 8192, dtype=torch.bool, device=dev)
        for i in range(2):
            dead[i, torch.randperm(8192, device=dev, generator=g)[
                :n_live]] = False
        live = ~dead
        for query, args, unmasked in (
                ("closest", (o, d, dead[0]), full),
                ("any", (o, segs[1], 1.0, dead[1]), full_occ[1]),
                ("multi", (o, segs, 1.0, dead), full_occ)):
            got = chip_smoke.bvh_run(query, tables, args, poison=True)
            want = chip_smoke.bvh_run(query, tables, args, kernel=False)
            mask = chip_smoke.dead_of(query, args)
            reading = chip_smoke.live_agreement(query, got, want, mask)
            assert not chip_smoke.rejects(reading, chip_smoke.BVH_LIMITS), (
                n_live, query, reading)
            if query == "closest":
                assert torch.equal(got[0][live[0]], unmasked[0][live[0]])
                assert torch.equal(got[1][live[0]], unmasked[1][live[0]])
                assert bool((got[0][dead[0]] == C.BIG).all())
                assert bool((got[1][dead[0]] == -1).all())
            else:
                assert torch.equal(got[~mask], unmasked[~mask])
                assert bool(got[mask].all())


@pytest.mark.cuda
def test_bvh_kernels_refuse_tables_of_another_width():
    """The launch refuses nodes of a width other than its kernel's: the
    binary tables (8 floats a node) and a 2-wide collapse."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets

    dev = _cuda()
    scene = _soup(dev, n=64)
    n = scene.n_objects
    args = (scene.prims.params[:n].cpu().numpy(),
            scene.prims.ptype[:n].cpu().numpy())
    o = torch.zeros(4, 3, device=dev)
    d = torch.ones(4, 3, device=dev)
    for tables in (packets.binary_tables(*args, device=dev),
                   packets.build_packets(*args, device=dev, width=2)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.bvh_closest(tables, o, d)
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.bvh_any(tables, o, d, 1.0)


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
    the BVH walk's; the plain version's count of the closest hit's work
    (intersect.brute_stages) records every test at one of its stages."""
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
    render_image(brute, RenderConfig())  # the capture
    got, n = chip_smoke.replay_launches(
        lambda: render_image(brute, RenderConfig()), (kernels.brute_closest,))
    assert n == {"brute_closest": 4}
    want = render_image(build_scene(sd, device=dev), RenderConfig())
    assert got.shape == (32, 32, 3) and bool(torch.isfinite(got).all())
    assert _bad_fraction(got, want) <= MAX_BAD
    stages = intersect.brute_stages(brute.prims, Rays.make(o, d))
    assert int(stages[:4].sum()) == 8192 * brute.brute.n_tri
    assert int(stages[4:].sum()) == 8192 * brute.brute.n_sph


@pytest.mark.cuda
def test_brute_kernels_trace_only_live_slots():
    """Masked queries on the card (csrc/brute_intersect.cu's compaction and
    table slices): with 0, 1, 31, 33, 4,097 and all 8,192 slots live, the
    live slots read the unmasked launch's answer bit for bit and the plain
    version's under chip_smoke.BRUTE_LIMITS, and the dead slots exactly
    (BIG, -1), or occluded, in outputs poisoned before the launch."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    dev = _cuda()
    soup = _soup(dev)
    prims = chip_smoke.subset(soup.prims)
    tables = intersect.brute_tables(prims)
    g = torch.Generator(device=dev).manual_seed(1)
    o = torch.rand(8192, 3, device=dev, generator=g) * 16 - 8
    d = torch.nn.functional.normalize(
        torch.randn(8192, 3, device=dev, generator=g), dim=-1)
    segs = torch.rand(8192, 3, device=dev, generator=g) * 16 - 8 - o
    full = kernels.brute_closest(tables, o, d)
    full_occ = kernels.brute_any(tables, o, segs, 1.0)
    for n_live in (0, 1, 31, 33, 4097, 8192):
        dead = torch.ones(8192, dtype=torch.bool, device=dev)
        dead[torch.randperm(8192, device=dev, generator=g)[:n_live]] = False
        live = ~dead
        for query, args, unmasked in (
                ("closest", (o, d, dead), full),
                ("any", (o, segs, 1.0, dead), full_occ)):
            got = chip_smoke.brute_run(query, tables, args, poison=True)
            want = chip_smoke.brute_plain(query, prims, args)
            reading = chip_smoke.live_agreement(query, got, want, dead)
            assert not chip_smoke.rejects(reading, chip_smoke.BRUTE_LIMITS), (
                n_live, query, reading)
            if query == "closest":
                assert torch.equal(got[0][live], unmasked[0][live])
                assert torch.equal(got[1][live], unmasked[1][live])
                assert bool((got[0][dead] == C.BIG).all())
                assert bool((got[1][dead] == -1).all())
            else:
                assert torch.equal(got[live], unmasked[live])
                assert bool(got[dead].all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("accel", [0, 2])
def test_wavefront_matches_sweep_on_the_card(accel):
    """The wavefront's queries on the card (the walk, or brute force over
    258 spheres) with the queue's dead suffix: its image is the sweep's to
    f32 reassociation (tests/test_wavefront.py:39), and engine="megakernel"
    on the field degrades to it without a Whitted launch."""
    dev = _cuda()
    scene = build_scene(sphere_field_scene(n_side=16, res=48, accel=accel),
                        device=dev)
    want = render_image(scene, RenderConfig())
    launched = (kernels.bvh_closest if accel else kernels.brute_closest)
    render_image(scene, RenderConfig(engine="wavefront"))  # the capture
    got, n = chip_smoke.replay_launches(
        lambda: render_image(scene, RenderConfig(engine="wavefront")),
        (launched,))
    assert n == {launched.__name__: 4}
    assert float((got - want).abs().max()) <= 5e-4
    whitted = kernels.whitted_megakernel.launches
    assert torch.equal(render_image(scene, RenderConfig(engine="megakernel")),
                       got)
    assert kernels.whitted_megakernel.launches == whitted


@pytest.mark.cuda
@pytest.mark.parametrize("accel", [1, 2])
def test_perray_traversal_on_the_card_equals_the_cpu(accel):
    """accel/traverse.py on CUDA tensors gives the CPU's ids and t."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import traverse

    dev = _cuda()
    sd = sphere_field_scene(n_side=16, res=32, accel=accel)
    scenes = [build_scene(sd, device=d) for d in (torch.device("cpu"), dev)]
    o, d = chip_smoke.camera_rays(scenes[0])
    d = d + 0.05 * torch.sin(torch.arange(d.numel()).reshape(d.shape) * 1.7)
    dead = torch.arange(o.shape[0]) % 5 == 0
    out = []
    for s in scenes:
        rays = Rays.make(o.to(s.device), d.to(s.device))
        if accel == 2:
            t, i = traverse.bvh_closest_hit(s.bvh, s.prims, rays,
                                            dead.to(s.device))
            occ = traverse.bvh_any_hit(s.bvh, s.prims, rays, 1.0)
        else:
            t, i = traverse.grid_closest_hit(s.grid, s.prims, rays,
                                             dead.to(s.device))
            occ = traverse.grid_any_hit(s.grid, s.prims, rays, 1.0,
                                        init_fail_occludes=True)
        out.append((t.cpu(), i.cpu(), occ.cpu()))
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])
    assert torch.allclose(out[0][0], out[1][0], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", chip_smoke.PERRAY_KINDS)
def test_perray_kernels_match_plain(kind):
    """chip_smoke.perray_cases at 64x64 (a 256-sphere field), 8,192 rays:
    each per-ray kernel of ``kind`` against its plain version under
    chip_smoke.PERRAY_LIMITS, writing into poisoned outputs: the frame's
    primaries, its level-1 rays and shadow segments with their dead masks,
    the initfail segments, the tie scene, the four-type soup and the
    corner grid's exit-axis ties."""
    dev = _cuda()
    n = 0
    for label, k, scene, query, args in chip_smoke.perray_cases(
            dev, res=64, n_side=16, n_rays=8192):
        if k != kind:
            continue
        got = chip_smoke.perray_run(k, query, scene, args, poison=True)
        want = chip_smoke.perray_run(k, query, scene, args, kernel=False)
        reading = chip_smoke.perray_agreement(query, got, want,
                                              chip_smoke.dead_of(query, args))
        assert not chip_smoke.rejects(reading, chip_smoke.PERRAY_LIMITS), (
            label, reading)
        n += 1
    assert n >= 12


@pytest.mark.cuda
def test_perray_kernels_count_and_refuse_cpu_and_grad_tensors():
    """Each dispatcher launches its kernel once on CUDA tensors; the
    wrappers refuse CPU tensors (ValueError) and grad tensors
    (NotImplementedError)."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import traverse

    dev = _cuda()
    o = torch.zeros(64, 3, device=dev)
    d = torch.nn.functional.normalize(torch.randn(
        64, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(
            4)), dim=-1)
    rays = Rays.make(o, d)
    for accel, closest, any_hit in (
            (2, kernels.perray_bvh_closest, kernels.perray_bvh_any),
            (1, kernels.grid_closest, kernels.grid_any)):
        scene = build_scene(sphere_field_scene(n_side=8, res=16,
                                               accel=accel), device=dev)
        tables = scene.bvh if accel == 2 else scene.grid
        rows = kernels.perray_rows(scene.prims)
        before = closest.launches, any_hit.launches
        if accel == 2:
            traverse.bvh_closest_hit(tables, scene.prims, rays)
            traverse.bvh_any_hit(tables, scene.prims, rays, 1.0)
        else:
            traverse.grid_closest_hit(tables, scene.prims, rays)
            traverse.grid_any_hit(tables, scene.prims, rays, 1.0,
                                  init_fail_occludes=True)
        assert (closest.launches - before[0],
                any_hit.launches - before[1]) == (1, 1)
        with pytest.raises(ValueError):
            closest(tables, rows, o.cpu(), d.cpu())
        with pytest.raises(ValueError):
            any_hit(tables, rows, o, d.cpu(), 1.0)
        with pytest.raises(ValueError):
            closest(tables, rows.cpu(), o, d)
        with pytest.raises(NotImplementedError):
            closest(tables, rows, o.requires_grad_(), d)
        with pytest.raises(NotImplementedError):
            any_hit(tables, rows, o, d, 1.0)
        o = o.detach()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["P1", "P2", "P2q"])
def test_perray_compiled_frame_equals_eager(path):
    """render_image under accel_impl="perray" on a 258-sphere field (P1
    the median BVH, P2 the grid DDA, P2q P2 under
    reference_grid_shadow_initfail) at 64x64, depth 4: one capture, each
    replay equal to the eager render_tile bit for bit, 4 closest and 8
    any-hit launches of the per-ray kernels a replay, counted on the
    device."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    dev = _cuda()
    accel = 2 if path == "P1" else 1
    scene = build_scene(sphere_field_scene(n_side=16, res=64, accel=accel),
                        device=dev)
    cfg = RenderConfig(accel_impl="perray",
                       reference_grid_shadow_initfail=path == "P2q")
    graphs.CACHE.clear()
    n0 = graphs.CACHE.captures
    compiled, eager, inputs = chip_smoke.whitted_path(scene, cfg)
    why = chip_smoke.replay_agreement(compiled, eager, inputs)
    assert not why and graphs.CACHE.captures == n0 + 1, why
    closest, any_hit = ((kernels.perray_bvh_closest, kernels.perray_bvh_any)
                        if accel == 2 else
                        (kernels.grid_closest, kernels.grid_any))
    _, n = chip_smoke.replay_launches(
        lambda: render_image(scene, cfg), (closest, any_hit))
    assert n == {closest.__name__: 4, any_hit.__name__: 8}
    graphs.CACHE.clear()


# ---------------------------------------------------------------------------
# gradients: the Whitted kernel's autograd.Function and grad-carrying rays


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["mount_low", "four-type, 2 lights",
                                   "distribution plan, sky u8"])
def test_function_gradients_equal_the_plain_versions(label):
    """chip_smoke.py phase 26: WhittedTrace's gradients of tbl, lt, bg, o
    and d against autograd straight through trace_rays_plain on the same
    CUDA tensors, under chip_smoke.GRAD_LIMIT; its forward is the kernel's
    output, one launch forward and none backward."""
    dev = _cuda()
    [(_, scene, cfg, s)] = [c for c in chip_smoke.function_cases(dev)
                            if c[0] == label]
    r = chip_smoke.function_readings(mk.WhittedTrace.apply, scene, cfg, s)
    assert not chip_smoke.function_rejects(r), r


@pytest.mark.cuda
def test_train_step_on_the_megakernel_launches_only_forward():
    """A train step on the megakernel engine routes through WhittedTrace:
    one Whitted launch (the forward), and the light's gradient moves it."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    dev = _cuda()
    scene = build_scene(mount_scene(res=32), device=dev)
    cfg = RenderConfig(engine="megakernel")
    target = render_image(scene, cfg)
    moved = scene.lights.position.clone()
    moved[0] += torch.tensor([1.0, -0.7, 0.5], device=dev)
    import dataclasses

    s = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, position=moved))
    before = kernels.whitted_megakernel.launches
    s2, loss = dist.train_step_full(s, target, cfg, 1e4, None,
                                    dist.lr_scales(materials=0.0,
                                                   light_color=0.0,
                                                   camera=0.0))
    assert kernels.whitted_megakernel.launches == before + 1
    assert bool(torch.isfinite(loss)) and not torch.equal(
        s2.lights.position, s.lights.position)
    assert "megakernel_tables" not in s.cache


@pytest.mark.cuda
@pytest.mark.parametrize("accel, impl, used", [
    (2, "auto", ("bvh_closest", "bvh_any")),
    (0, "auto", ("brute_closest", "brute_any")),
    (2, "perray", ("perray_bvh_closest", "perray_bvh_any")),
    (1, "perray", ("grid_closest", "grid_any"))],
    ids=["walk", "brute", "median_bvh", "grid"])
def test_grad_carrying_rays_through_every_traversal_on_the_card(accel, impl,
                                                                used):
    """The eye and the lights require grad, so every ray does: the walk,
    brute force and the per-ray traversals take the rays detached, without
    raising; the render's gradient is finite."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist

    dev = _cuda()
    scene = build_scene(sphere_field_scene(n_side=8, res=32, accel=accel),
                        device=dev)
    counted = [getattr(kernels, n) for n in used]
    before = [k.launches for k in counted]
    loss, g = dist.value_and_grad(
        scene, torch.full((32, 32, 3), 0.5, device=dev),
        RenderConfig(engine="wavefront", accel_impl=impl), None,
        ("materials",))
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(x).all()) for x in dist.tree_leaves(g))
    assert float(g.cam_eye.abs().max()) > 0.0
    assert all(k.launches > b for k, b in zip(counted, before))


@pytest.mark.cuda
def test_wrappers_refuse_grad_where_the_dispatchers_detach():
    """A grad tensor handed to a kernel wrapper is refused; the same rays
    through the dispatchers are detached and traced."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    dev = _cuda()
    soup = _soup(dev, n=40)
    o = torch.zeros(64, 3, device=dev, requires_grad=True)
    d = torch.nn.functional.normalize(torch.randn(
        64, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(
            2)), dim=-1).requires_grad_()
    for call in (lambda: kernels.bvh_closest(soup.packets, o, d),
                 lambda: kernels.bvh_any_multi(soup.packets, o, d[None], 1.0),
                 lambda: kernels.brute_closest(soup.brute, o, d),
                 lambda: kernels.brute_any(soup.brute, o, d, 1.0)):
        with pytest.raises(NotImplementedError, match="dispatchers"):
            call()
    rays = Rays.make(o, d)
    t1, i1 = packets.packet_closest_hit(soup.packets, rays)
    t2, i2 = intersect.closest_hit_brute(soup.prims, rays, soup.brute)
    occ = packets.packet_any_hit_multi(soup.packets, o, [d], 1.0)
    assert not (t1.requires_grad or t2.requires_grad or occ.requires_grad)
    assert torch.equal(i1, i2)


@pytest.mark.cuda
def test_with_prim_params_repacks_the_brute_force_tables():
    """A sphere moved by with_prim_params is where the brute-force kernel
    finds it: rays aimed at its new centre hit it, at its old one miss."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core import constants as C
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        with_prim_params,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import intersect

    dev = _cuda()
    scene = _soup(dev, n=40)
    row = int(torch.nonzero(scene.prims.ptype == C.SPHERE)[0, 0])
    params = scene.prims.params.clone()
    old = params[row, 0:3].clone()
    params[row, 0:3] = torch.tensor([40.0, 40.0, 40.0], device=dev)
    moved = with_prim_params(scene, params)
    o = torch.tensor([[40.0, 40.0, 30.0]], device=dev)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=dev)
    before = kernels.brute_closest.launches
    _, ids = intersect.closest_hit_brute(moved.prims, Rays.make(o, d),
                                         moved.brute)
    assert kernels.brute_closest.launches == before + 1
    assert int(ids[0]) == row
    o2 = (old + torch.tensor([0.0, 0.0, -30.0], device=dev))[None]
    _, ids2 = intersect.closest_hit_brute(moved.prims, Rays.make(o2, d),
                                          moved.brute)
    assert int(ids2[0]) != row


# ---------------------------------------------------------------------------
# the compiled programs (utils/graphs.py): replays against the eager
# functions


@pytest.mark.cuda
def test_compiled_programs_replay_the_eager_ones():
    """chip_smoke.py phase 34's checks at 64x64: mount_low's megakernel
    frame and its distribution frame on two seeds and an advanced
    generator (bit for bit, the generator left as eager leaves it), the
    16-frame orbit in one capture, 16 progressive path-tracer frames, and
    two chained train steps within GRAD_LIMIT."""
    dev = _cuda()
    why = chip_smoke.graph_checks(dev, 64)
    assert not any(why.values()), why


@pytest.mark.cuda
@pytest.mark.parametrize("accel, engine", [
    (None, "sweep"), (None, "wavefront"), (None, "megakernel"),
    ("dist", "sweep"), ("dist", "wavefront"),
    (0, "sweep"), (0, "wavefront"), (2, "sweep"), (2, "wavefront")],
    ids=["mount-sweep", "mount-wavefront", "mount-megakernel",
         "distribution-sweep", "distribution-wavefront",
         "brute-sweep", "brute-wavefront", "walk-sweep", "walk-wavefront"])
def test_compiled_frame_on_each_engine_equals_eager(accel, engine):
    """render_image's graph on each engine (mount_low; its distribution
    frame, spp 2 with soft shadows and fuzzy reflection; a 258-sphere
    field on brute force and on the walk) equals the eager render_tile bit
    for bit on two seeds and an advanced generator, one capture for every
    input."""
    import dataclasses

    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    dev = _cuda()
    cfg = RenderConfig(engine=engine)
    if accel in (None, "dist"):
        scene = build_scene(mount_scene(res=64), device=dev)
    else:
        scene = build_scene(sphere_field_scene(n_side=16, res=64,
                                               accel=accel), device=dev)
    if accel == "dist":
        scene = dataclasses.replace(scene, spp=2)
        cfg = dataclasses.replace(cfg, soft_shadow=True,
                                  fuzzy_reflection=True).with_scene_flags(
                                      scene)
    graphs.CACHE.clear()
    n0 = graphs.CACHE.captures
    why = chip_smoke.replay_agreement(*chip_smoke.whitted_path(scene, cfg))
    assert not why and graphs.CACHE.captures == n0 + 1, why
    graphs.CACHE.clear()


@pytest.mark.cuda
def test_graph_cache_keeps_memory_bounded_over_new_scenes():
    """One freshly built BVH field after another (new tables each, so a new
    capture each) keeps PER_PROGRAM graphs of the frame, and the card's
    reserved memory stops growing once the cache is full."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    dev = _cuda()
    graphs.CACHE.clear()
    n0 = graphs.CACHE.captures
    keep = graphs.PER_PROGRAM
    reserved = []
    for _ in range(3 * keep):
        scene = build_scene(sphere_field_scene(n_side=8, res=64, accel=2),
                            device=dev)
        render_image(scene, RenderConfig())
        del scene
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved(dev))
    assert graphs.CACHE.captures - n0 == 3 * keep
    assert len(graphs.CACHE.graphs) == keep
    pool = max(g.pool_mib for g in graphs.CACHE.graphs.values()) * 2**20
    assert reserved[-1] <= reserved[keep - 1] + 2 * pool, reserved
    graphs.CACHE.clear()


@pytest.mark.cuda
def test_capture_of_a_host_sync_raises():
    """A program that reads a device value on the host cannot be
    captured: the call raises, naming the program, and nothing runs
    eagerly in its place."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    dev = _cuda()
    cache = graphs.GraphCache()

    def host_sync(x, generator):
        return x * float(x.sum())

    with pytest.raises(RuntimeError, match="capturing host_sync") as e:
        cache.call("host_sync", host_sync, (torch.ones(4, device=dev),))
    assert e.value.__cause__ is not None
    assert not cache.graphs and cache.captures == 0
    assert torch.equal(torch.ones(2, device=dev) * 2,
                       torch.full((2,), 2.0, device=dev))


@pytest.mark.cuda
def test_sharded_programs_compile_without_a_group():
    """Without a process group the sharded functions are compiled on the
    card too (the collective is absent, so each is one graph): two frames
    of each bit-equal to the eager sharded calls, the path tracer's from
    one generator, left where eager leaves it; the step within
    chip_smoke.GRAD_LIMIT of the eager one."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    dev = _cuda()
    graphs.CACHE.clear()
    scene = build_scene(mount_scene(res=64), device=dev)
    cfg = RenderConfig(engine="megakernel")
    want = dist.render_image_sharded_eager(scene, cfg)
    for _ in range(2):
        assert torch.equal(dist.render_image_sharded(scene, cfg), want)
    world, cam = glsl_world(device=dev), glsl_camera(64, 64, device=dev)
    pcfg = pt.PTConfig(max_bounces=3)
    g, e = (torch.Generator(device=dev).manual_seed(3) for _ in range(2))
    for _ in range(2):
        assert torch.equal(dist.pt_frame_sharded(world, cam, pcfg, None, g),
                           dist.pt_frame_sharded_eager(world, cam, pcfg,
                                                       None, e))
    assert torch.equal(g.get_state(), e.get_state())
    start, target, tcfg, lr, sc = chip_smoke.train_setup(dev, "megakernel",
                                                         64)
    step = dist.make_train_step(dist.train_step_full, tcfg, lr, scales=sc)
    assert chip_smoke.step_agreement(
        step, lambda s, t: dist.train_step_full(s, t, tcfg, lr, None, sc),
        start, target) == []
    names = sorted(k[0] for k in graphs.CACHE.graphs)
    assert names.count("dist.render_image_sharded") == 1
    assert names.count("dist.pt_frame_sharded") == 1
    assert names.count("dist.train_step_full") == 1
    graphs.CACHE.clear()
