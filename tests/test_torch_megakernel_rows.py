"""The megakernels' tables as the kernels read them, the texts chip_faults.py
plants in the kernel sources, and tools/megakernels.py's readers of ptxas
and cuobjdump, on the CPU.

The megakernels read a table row as six 16-byte loads: rows of 24 floats,
16-byte aligned. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py); the plain versions on these
tables are held to the JAX package by test_torch_megakernel.py,
test_torch_dist_megakernel.py and test_torch_pt_megakernel.py."""
import pytest
import torch

import chip_faults
import chip_smoke
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import build_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.kernels import build as kb
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    pt_megakernel as ptk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import pathtracer as pt
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_megakernel as mk,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.tools import megakernels as mt
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def test_whitted_rows_hold_geometry_material_and_a_pad():
    """Every primitive type: 12 floats of geometry, the 11 of its material,
    a zero pad; the earlier 23-float rows are these rows without the
    pad."""
    scene = build_scene(chip_smoke.four_type_scene(8), device=CPU)
    tbl, lt, bg = mk.scene_tables(scene)
    shape = mk.shape_of(scene)
    assert (shape.n_tri, shape.n_sph, shape.n_pl, shape.n_box) == (1, 2, 1, 1)
    assert mk.TBL_W == 24 and tbl.shape == (shape.n * 24,)
    assert tbl.data_ptr() % 16 == 0
    rows = tbl.reshape(shape.n, 24)
    p, m = scene.prims, scene.materials
    geom = [p.tri_p[0], p.sph_p[0], p.sph_p[1], p.pl_p[0], p.box_p[0]]
    ids = [p.tri_ids[0], p.sph_ids[0], p.sph_ids[1], p.pl_ids[0],
           p.box_ids[0]]
    for row, g, i in zip(rows, geom, ids):
        mi = int(p.mat_id[int(i)])
        assert torch.equal(row[:g.shape[0]], g)
        assert not row[g.shape[0]:12].any()
        assert torch.equal(row[12:23], torch.cat([
            m.diff_color[mi], m.spec_color[mi],
            torch.stack([m.kd[mi], m.ks[mi], m.shine[mi], m.transmit[mi],
                         m.ior[mi]])]))
        assert row[23] == 0.0
    again = mk.reconstruct_scene(shape, tbl, lt, bg)
    assert torch.equal(mk.scene_tables(again)[0], tbl)
    old = mt.with_rows("whitted_megakernel", 23, (tbl,))[0]
    assert torch.equal(old.reshape(shape.n, 23), rows[:, :23])


def test_pt_rows_hold_padded_geometry_then_the_material():
    """Spheres (static, moving, a hollow shell) and triangles: 9 floats of
    geometry, 3 zero pads, the 12 of the material; the earlier 21-float
    rows are these rows without the pads; the plain version on the scene read back
    from the rows equals the plain version on the world."""
    world = chip_smoke.tiny_pt_world(CPU)
    t = ptk.pt_tables(world)
    assert (t.n_sph, t.n_tri) == (7, 2) and ptk.ROW_W == 24
    assert t.tbl.data_ptr() % 16 == 0
    rows = t.tbl.reshape(-1, 24)
    sph = torch.cat([world.sp_center0, world.sp_center1,
                     world.sp_radius[:, None], world.sp_time0[:, None],
                     world.sp_time1[:, None]], dim=-1)
    tri = torch.cat([world.tri_v0, world.tri_e1, world.tri_e2], dim=-1)
    assert torch.equal(rows[:, :9], torch.cat([sph, tri]))
    assert not rows[:, 9:ptk.GEOM_W].any()
    mats = world.materials
    mi = torch.cat([world.sp_mat, world.tri_mat]).long()
    assert torch.equal(rows[:, ptk.GEOM_W:], torch.cat([
        mats.mtype[mi].float()[:, None], mats.albedo[mi],
        mats.spec_color[mi], mats.roughness[mi][:, None],
        mats.ref_idx[mi][:, None], mats.refract_color[mi]], dim=-1))
    old = mt.with_rows("pt_megakernel", 21, (t,))[0].tbl.reshape(-1, 21)
    assert torch.equal(old, torch.cat([rows[:, :9], rows[:, 12:]], dim=-1))

    g = torch.Generator().manual_seed(7)
    cam = chip_smoke.pt_time_span(_tiny_camera())
    cfg = pt.PTConfig(max_bounces=3)
    rays = pt.camera_rays(cam, g)
    uni = pt.draw_uniforms(g, 3, 64)
    assert torch.equal(
        pt.ray_color_presampled(ptk.scene_from_tables(t), cfg, rays, uni),
        pt.ray_color_presampled(world, cfg, rays, uni))


def _tiny_camera():
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_camera,
    )

    return build_camera(dict(eye=[0.0, 2.0, 6.0], at=[0, 0.5, -1],
                             up=[0, 1, 0], fov=60.0, hither=0.01, res_x=8,
                             res_y=8, aperture_ratio=0.0, focal_ratio=1.0),
                        device=CPU)


_PLANTED = (
    [("whitted_megakernel", n, [(a, b)])
     for n, a, b in chip_faults.WHITTED_FAULTS]
    + [("whitted_megakernel", n, list(e))
       for n, e, _, _ in chip_faults.WHITTED_CONTROLS]
    + [("whitted_megakernel", n, list(e))
       for n, e in chip_faults.WHITTED_DESIGN]
    + [("pt_megakernel", n, [(a, b)]) for n, a, b in chip_faults.PT_FAULTS]
    + [("pt_megakernel", n, list(e)) for n, e in chip_faults.PT_DESIGN]
    + [("bvh_walk", n, [(a, b)]) for n, a, b in chip_faults.BVH_FAULTS]
    + [("bvh_walk", n, list(e)) for n, e in chip_faults.BVH_DESIGN]
    + [("brute_intersect", n, [(a, b)])
       for n, a, b in chip_faults.BRUTE_FAULTS]
    + [("brute_intersect", n, list(e))
       for n, e in chip_faults.BRUTE_CONTROLS]
    + [("probes", n, [(a, b)]) for n, a, b in chip_faults.PROBE_FAULTS]
    + [("perray_traverse", n, [(a, b)])
       for n, a, b in chip_faults.PERRAY_FAULTS])


@pytest.mark.parametrize("source,name,edits", _PLANTED,
                         ids=[f"{s}: {n}" for s, n, _ in _PLANTED])
def test_planted_text_is_in_its_source_once(source, name, edits):
    """chip_faults.py builds each fault and control by replacing texts of
    the source and the headers beside it (kernels/build.build_copy, which
    refuses a text found other than once): each text is there once, and
    each replacement changes the source."""
    texts = [(kb.CSRC / f"{source}.cu").read_text(),
             *(h.read_text() for h in sorted(kb.CSRC.glob("*.cuh")))]
    for old, new in edits:
        assert sum(t.count(old) for t in texts) == 1, old
        assert new != old


@pytest.mark.parametrize("name", mt.KERNELS)
def test_block_size_edits_find_their_text(name):
    text = (kb.CSRC / f"{name}.cu").read_text()
    for threads in (64, 128, 256):
        for old, _ in mt.thread_edits(text, threads):
            assert text.count(old) == 1
    edits = mt.min_block_edits(text, 6)
    if "kMinBlocks" in text:  # the Whitted kernel's launch bounds
        [(old, new)] = edits
        assert text.count(old) == 1 and new == "constexpr int kMinBlocks = 6;"
    else:
        assert edits is None
    assert mt.row_width(kb.CSRC, name) == 24


def test_ptxas_and_sass_readers():
    log = """ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__b7ab5af_21_whitted_megakernel_cu_ddbc929814whitted_kernelILi4EEEv6Params' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__b7ab5af_21_whitted_megakernel_cu_ddbc929814whitted_kernelILi4EEEv6Params
    32 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 468 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__f3e49c_16_pt_megakernel_cu_65bddb599pt_kernelE6Params' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__f3e49c_16_pt_megakernel_cu_65bddb599pt_kernelE6Params
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers, 432 bytes cmem[0]
"""
    assert mt.ptxas_resources(log) == {
        "whitted_kernel<4>": {"stack": 32, "spill_stores": 12,
                              "spill_loads": 8, "registers": 126},
        "pt_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                      "registers": 63}}
    sass = """\tFunction : _ZN37_GLOBAL__N__f3e49c_16_pt_megakernel_cu_65bddb599pt_kernelE6Params
        /*0000*/                   MOV R1, c[0x0][0x28] ;        /* 0x00000a0000017a02 */
                                                                 /* 0x000fc40000000f00 */
        /*0010*/                   FADD R2, R3, R4 ;
        /*0020*/                   FMUL R2, R2, R4 ;
        /*0030*/              @P0 BRA 0x10 ;
        /*0040*/                   BRA 0x60 ;
        /*0050*/                   EXIT ;
"""
    assert mt.sass_loops(sass) == {"pt_kernel": {"instructions": 6,
                                                 "loops": [3]}}


@pytest.mark.parametrize("registers,threads,smem,blocks", [
    (126, 128, 1128, 4),   # the unpadded K1 at depth 4: 16 warps of 64
    (63, 128, 8808, 8),    # the unpadded K3
    (76, 128, 1128, 6),
    (128, 64, 1128, 8),
    (32, 128, 0, 16),      # warps bound it: 64 an SM
    (32, 32, 0, 32),       # blocks bound it
    (32, 128, 100_000, 2),  # shared memory bounds it
])
def test_blocks_per_sm(registers, threads, smem, blocks):
    assert mt.blocks_per_sm(registers, threads, smem) == blocks


def test_work_models_count_a_warps_deepest_ray():
    """chip_smoke's work models count, beside the nodes and live bounces,
    the steps of warps of 32 consecutive rays whose lanes step together:
    at least the work over 32, at most the deepest walk in every warp."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
        mount_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        pixel_grid,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import (
        pinhole_rays,
    )

    assert chip_smoke.warp_max_sum(torch.tensor([1] * 31 + [5, 2])) == 7
    scene = build_scene(mount_scene(res=16), device=CPU)
    px, py = pixel_grid(16, 16, CPU)
    r = pinhole_rays(scene.camera, px + 0.5, py + 0.5)
    w = chip_smoke.whitted_work(scene, r.origin, r.direction,
                                RenderConfig(engine="megakernel"))
    assert w["tests"] <= 32 * w["warp_nodes"] <= 15 * 256
    assert w["warp_nodes"] >= 256 // 32
    cam = chip_smoke.pt_time_span(_tiny_camera())
    cfg = pt.PTConfig(max_bounces=3)
    g = torch.Generator().manual_seed(7)
    rays = pt.camera_rays(cam, g)
    uni = pt.draw_uniforms(g, 3, 64)
    w = chip_smoke.pt_work(chip_smoke.tiny_pt_world(CPU), cfg, rays, uni)
    assert w["tests"] <= 32 * w["warp_bounces"] <= 3 * 64
    assert w["warp_bounces"] >= 64 // 32


def test_walk_tool_reads_the_walks_source_and_symbols(tmp_path):
    """tools/megakernels.py on the BVH walk: its block-size edits find
    their text, ``walk_width`` reads the node width (0 for the binary walk
    of PRs 3-8, whose source has no kWidth), and the walk's bool template
    instantiations keep their names apart."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.accel import packets

    text = (kb.CSRC / f"{mt.WALK}.cu").read_text()
    for threads in (64, 128, 256):
        for old, _ in mt.thread_edits(text, threads):
            assert text.count(old) == 1
    assert mt.min_block_edits(text, 6) is None
    assert mt.walk_width(kb.CSRC) == packets.WIDTH
    (tmp_path / f"{mt.WALK}.cu").write_text(
        text.replace("constexpr int kWidth = 4;", ""))
    assert mt.walk_width(tmp_path) == 0
    names = {mt.demangle(f"_ZN44_GLOBAL__N__553bf59a_11_bvh_walk_cu_4426ee18"
                         f"{k}ILb{b}EEEvPKfS2_iPKhNS_6TablesEPfPiS7_")
             for k in ("14closest_kernel", "10any_kernel") for b in (0, 1)}
    assert names == {"closest_kernel<true>", "closest_kernel<false>",
                     "any_kernel<true>", "any_kernel<false>"}
    log = ("ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__5"
           "_bvh_walk_cu_414closest_kernelILb0EEEvPKf' for 'sm_90a'\n"
           "    512 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 69 registers, used 1 barriers, 512 "
           "bytes cumulative stack size, 528 bytes smem\n")
    assert mt.ptxas_resources(log) == {"closest_kernel<false>": {
        "stack": 512, "spill_stores": 0, "spill_loads": 0, "registers": 69,
        "smem": 528}}


def test_frame_queries_record_the_sweeps_walk_and_brute_queries():
    """frame_queries records each level's closest hit and each level's and
    light's shadow query as the sweep hands them to the accelerator, with
    their dead masks; the walk and brute force are handed the same ones."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
        sphere_field_scene,
    )

    scene = build_scene(sphere_field_scene(n_side=8, res=16), device=CPU)
    o, d = chip_smoke.camera_rays(scene)
    walk = mt.frame_queries(scene, o, d, RenderConfig())
    brute = mt.frame_queries(scene, o, d, RenderConfig(accel_impl="brute"))
    closest, shadows = walk
    assert len(closest) == 4 and len(shadows) == 4 * scene.n_lights
    assert [q[0].shape[0] for q in closest] == [256, 512, 1024, 2048]
    assert not bool(closest[0][2].any()) and bool(closest[3][2].any())
    assert all(q[2] == 1.0 for q in shadows)
    for got, want in zip(walk[0] + walk[1], brute[0] + brute[1]):
        for a, b in zip(got, want):
            assert a == b if isinstance(a, float) else torch.equal(a, b)
    assert mt.warp_max_sum(torch.tensor([1] * 31 + [5, 2])) == 7
