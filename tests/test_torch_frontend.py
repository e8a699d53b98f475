"""The port's front-end helpers against the JAX package's: the terminal
preview (io/image.preview_u8 and ansi_halfblock), the orbit camera
(ops/camera.orbit_eye), the scene loader (core/build.load_scene) and the
profiling helpers (utils/profiling: PhaseTiming, RenderStats, ray_count,
and trace on torch.profiler in place of JAX's xla_trace)."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu.io import image as jax_image
from u_4a_2s_p3d_raytracer_template2_tpu.ops.camera import (
    orbit_eye as jax_orbit_eye,
)
from u_4a_2s_p3d_raytracer_template2_tpu.utils import (
    profiling as jax_profiling,
)

import u_4a_2s_p3d_raytracer_template2_tpu_torch as rt
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
    build_scene,
    load_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.image import (
    ansi_halfblock,
    preview_u8,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.p3f import parse_p3f
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera import orbit_eye
from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import profiling

from torch_parity import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")

P3F = """# two spheres, a triangle and a plane under two lights
accel 0
v from 0 1 5 at 0 0 0 up 0 1 0 angle 45 hither 0.01
  resolution 24 16 aperture 0 focal 1
bclr 0.1 0.2 0.3
f 0.8 0.2 0.2 0.9 1 1 1 0.1 30 0 1
s 0 0 0 1
s 1.5 0.2 -1 0.4
f 0.4 0.4 0.9 1 1 1 1 0 10 0 1
p 3 -1 -1 1 1 -1 1 0 0.5 1
pl 0 -1 0 1 -1 0 0 -1 -1
l 5 5 5 1 1 1
l -4 6 2 0.4 0.4 0.6
"""


def test_ansi_halfblock_equals_jax():
    img = np.random.default_rng(7).integers(0, 256, (9, 13, 3), np.uint8)
    want = jax_image.ansi_halfblock(img)
    assert ansi_halfblock(img) == want
    assert ansi_halfblock(torch.from_numpy(img)) == want
    assert ansi_halfblock(img).encode() == want.encode()


def test_ansi_halfblock_exact():
    """tests/test_cli_live.py::test_ansi_halfblock_exact."""
    img = np.array([[[0, 0, 0], [255, 0, 0]],
                    [[0, 255, 0], [0, 0, 255]]], np.uint8)
    assert ansi_halfblock(img) == (
        "\x1b[38;2;0;255;0m\x1b[48;2;0;0;0m▀"
        "\x1b[38;2;0;0;255m\x1b[48;2;255;0;0m▀\x1b[0m")


@pytest.mark.parametrize("h,w,cols", [(32, 48, 12), (512, 512, 80),
                                      (37, 53, 11), (16, 16, 8),
                                      (64, 40, 80)])
def test_preview_u8_within_one_level_of_jax(h, w, cols):
    img = np.random.default_rng(h * w).random((h, w, 3), np.float32)
    img[0, 0] = (1.2, -0.1, 0.5)  # saturates as u8_from_float does
    want = np.asarray(jax_image.preview_u8(jnp.asarray(img), cols))
    got = preview_u8(torch.from_numpy(img), cols)
    assert got.dtype == torch.uint8 and got.device == CPU
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_preview_u8_shape_and_range():
    """tests/test_cli_live.py::test_preview_u8_shape_and_range."""
    img = torch.linspace(0, 1, 32 * 48 * 3).reshape(32, 48, 3)
    small = preview_u8(img, cols=12)
    assert small.shape[1] == 12 and small.shape[0] % 2 == 0
    assert small.dtype == torch.uint8


@pytest.mark.parametrize("alpha,beta,r", [(0.0, 20.0, 5.0),
                                          (-43.26, 85.0, 0.1),
                                          (360.0 * 7 / 8, -30.0, 12.5)])
def test_orbit_eye_against_jax(alpha, beta, r):
    cam = build_scene(mount_scene(res=8), device=CPU).camera
    got = orbit_eye(cam, alpha, beta, r)
    assert got.dtype == torch.float32 and got.shape == (3,)
    want = np.asarray(jax_orbit_eye(None, alpha, beta, r))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_load_scene_equals_build_of_parse(tmp_path):
    path = tmp_path / "two_spheres.p3f"
    path.write_text(P3F)
    got = load_scene(str(path), device=CPU)
    want = build_scene(parse_p3f(str(path)), device=CPU)
    assert (got.n_objects, got.n_lights, got.camera.res_x,
            got.camera.res_y) == (4, 2, 24, 16)
    for group in ("prims", "materials", "lights", "camera"):
        a, b = getattr(got, group), getattr(want, group)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f"{group}.{f.name}"
            else:
                assert x == y, f"{group}.{f.name}"
    assert rt.load_scene is load_scene and callable(rt.load_png)


@pytest.mark.parametrize("args", [(512, 512, 1), (800, 600, 3, 4, 5),
                                  (16, 16, 2, 2, 2)])
def test_ray_count_equals_jax(args):
    assert profiling.ray_count(*args) == jax_profiling.ray_count(*args)


def test_render_stats_report_equals_jax():
    got, want = profiling.RenderStats(), jax_profiling.RenderStats()
    got.phases = [profiling.PhaseTiming("render", 0.25, 262144 * 2),
                  profiling.PhaseTiming("build", 0.0125)]
    want.phases = [jax_profiling.PhaseTiming("render", 0.25, 262144 * 2),
                   jax_profiling.PhaseTiming("build", 0.0125)]
    assert got.report() == want.report()
    assert got.json() == want.json()
    with got.phase("timed", rays=10):
        pass
    assert got.phases[-1].name == "timed" and got.phases[-1].seconds >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    events = json.loads((tmp_path / "trace.json").read_text())
    assert events["traceEvents"]
    with profiling.trace(None) as prof:
        pass
    assert prof is None and os.listdir(tmp_path) == ["trace.json"]
