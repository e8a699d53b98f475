"""Distribution mode through the port's Whitted megakernel engine: jittered
soft shadows, fuzzy reflection and everything together against the JAX
package's ``render_tile`` on its own draws; the stream rows and their
layout against the JAX megakernel's ``_draw_stream`` and
``_stream_layout``; the kernel's plain version against the sweep.

Images are held to ``assert_images_close`` (atol 2e-3 on all but 1% of
pixels). The rows are held to 1e-6: the port's cube root is ``pow(u,
1/3)`` where JAX's is ``cbrt``, a few ulp apart (ops/sampling.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.models import (
    whitted_megakernel as jmk,
)
from u_4a_2s_p3d_raytracer_template2_tpu.models.scenes import (
    mount_scene as jax_mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch import kernels
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import samples
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import whitted as pw
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import (
    whitted_megakernel as mk,
)
from test_megakernel import _test_skybox
from test_torch_distribution import _jax_scene, _pixels, sweep_against_jax
from torch_parity import (  # one_torch_thread: an autouse fixture
    jax_scene_to_port,
    jax_stream_raw,
    mixed_scene,
    one_torch_thread,
)

SOFT_AA = dict(anti_aliasing=True, spp=2, soft_shadow=True)


@pytest.mark.parametrize("flags,depth", [
    (SOFT_AA, 2),
    (dict(fuzzy_reflection=True), 3),
    (dict(SOFT_AA, fuzzy_reflection=True, depth_of_field=True,
          motion_blur=True, use_skybox=True), 3),
], ids=["soft_aa", "fuzzy", "all_with_sky"])
def test_sweep_matches_jax_render_tile(flags, depth):
    jscene = dataclasses.replace(_jax_scene(), skybox=_test_skybox(),
                                 has_skybox=True)
    sweep_against_jax(jscene, flags, depth, seed=4)


def _layout_cases():
    mixed = rt.build_scene(mixed_scene(rt.SceneDef(), res=4))
    mount = rt.build_scene(jax_mount_scene(res=4))
    refl_only = dataclasses.replace(mixed, has_transmissive=False)
    diffuse = dataclasses.replace(mixed, has_reflective=False,
                                  has_transmissive=False)
    flags = [SOFT_AA, dict(fuzzy_reflection=True),
             dict(SOFT_AA, fuzzy_reflection=True)]
    for scene in (mixed, mount, refl_only, diffuse):
        for kw in flags:
            for depth in (1, 3, 4):
                yield scene, rt.RenderConfig(max_depth=depth, **kw)


def test_layout_equals_jax_stream_layout():
    for jscene, cfg in _layout_cases():
        want_n, want_map = jmk._stream_layout(jmk._SceneConsts(jscene), cfg)
        layout = samples.stream_layout(
            jscene.has_reflective, jscene.has_transmissive, jscene.n_lights,
            pt.RenderConfig(**dataclasses.asdict(cfg)))
        assert (layout.n_rows, layout.rowmap) == (want_n, want_map)
        # the node-base formula the CUDA kernel computes (node_row)
        for key, rows in layout.rowmap.items():
            lvl, path = key[1], key[2]
            first = layout.level_base[lvl] + path * layout.node_rows[lvl]
            off = (2 * key[3] if key[0] == "shadow"
                   else layout.fuzzy_offset())
            assert rows[0] == first + off


@pytest.mark.parametrize("ij", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)])
def test_stream_rows_equal_jax_draw_stream(ij):
    jscene = rt.build_scene(mixed_scene(rt.SceneDef(), res=4))
    cfg = rt.RenderConfig(max_depth=3, fuzzy_reflection=True, **SOFT_AA)
    consts = jmk._SceneConsts(jscene)
    key, R = jax.random.PRNGKey(11), 37
    want = np.asarray(jmk._draw_stream(consts, cfg, R, key, ij))
    layout = samples.stream_layout(True, True, jscene.n_lights,
                                   pt.RenderConfig(**dataclasses.asdict(cfg)))
    raw = torch.from_numpy(jax_stream_raw(key, layout, R))
    got = samples.stream_rows(raw, layout, ij, cfg.spp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_megakernel_plain_equals_sweep():
    """The megakernel engine on CPU tensors (the kernel's plain version over
    the rebuilt tables) and the sweep read the same draws and agree; the
    kernel's wrapper refuses CPU tensors before any build."""
    port = jax_scene_to_port(dataclasses.replace(
        _jax_scene(res=10), skybox=_test_skybox(), has_skybox=True))
    cfg = pt.RenderConfig(max_depth=3, fuzzy_reflection=True,
                          depth_of_field=True, use_skybox=True, **SOFT_AA)
    px, py = (torch.from_numpy(a) for a in _pixels(10))
    draws = samples.draw_plan(torch.Generator().manual_seed(2),
                              samples.scene_layout(port, cfg), cfg, 100)
    sweep = pw.render_tile(port, px, py, cfg, draws=draws)
    mega = pw.render_tile(port, px, py,
                          dataclasses.replace(cfg, engine="megakernel"),
                          draws=draws)
    torch.testing.assert_close(mega, sweep, rtol=0, atol=1e-5)
    tbl, lt, bg = mk.scene_tables(port)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.whitted_megakernel(tbl, lt, bg, px[:, None].expand(-1, 3),
                                   px[:, None].expand(-1, 3),
                                   mk.shape_of(port), cfg,
                                   draws[0].rows, port.skybox, (0.0, 0.0))


def test_plain_version_needs_its_rows():
    scene = jax_scene_to_port(_jax_scene(res=4))
    cfg = pt.RenderConfig(fuzzy_reflection=True)
    o = torch.zeros(16, 3)
    d = torch.tensor([0.0, 0.0, -1.0]).expand(16, 3)
    tbl, lt, bg = mk.scene_tables(scene)
    with pytest.raises(ValueError, match="sample rows"):
        mk.trace_rays_plain(mk.shape_of(scene), tbl, lt, bg, o, d, cfg)
