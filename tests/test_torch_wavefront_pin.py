"""Pins the one place where the port's wavefront engine departs from the JAX
package's: JAX's queue drops a child whose throughput weight has no
positive component (JAX models/whitted_wavefront.py:125-127), and Schlick's
KR is negative on some refractive hits in the reference refraction mode,
so JAX's wavefront loses those children where its sweep folds them in. The
port queues every nonzero weight, so its wavefront equals the sweep.

mount_low at 24x24, depth 4, the default RenderConfig: the port's
wavefront equals JAX's sweep within 5e-4 (tests/test_wavefront.py:39), and
JAX's wavefront, rendered in the test, differs from JAX's sweep at image
row 13, column 11, blue by 1.61e-3. JAX's sweep image comes from
tests/fixtures/mount_jax_refs.npz (tests/make_grad_fixture.py: compiling
the sweep's ops takes 15-25 s on an 8-core x86 host), and the JAX
wavefront rendered live equals the fixture's, so the fixture stays the JAX
package's answer.
"""
import numpy as np
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
from u_4a_2s_p3d_raytracer_template2_tpu.models.scenes import (
    mount_scene as jax_mount_scene,
)

from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import build_scene
from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import RenderConfig
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
    mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    render_image,
)
from make_grad_fixture import FIXTURE, PIN_RES
from torch_parity import jax_render_image, one_torch_thread  # noqa: F401

ATOL = 5e-4             # tests/test_wavefront.py:39
PIXEL = (13, 11, 2)     # image row, column, channel (blue)
JAX_DEVIATION = 1.61e-3  # JAX's wavefront against its sweep there


def test_port_wavefront_equals_jax_sweep_where_jax_wavefront_departs():
    refs = np.load(FIXTURE)
    jax_sweep = refs["pin/sweep"]
    jax_wave = jax_render_image(rt.build_scene(jax_mount_scene(res=PIN_RES)),
                                rt.RenderConfig(engine="wavefront"))
    np.testing.assert_allclose(jax_wave, refs["pin/wavefront"], rtol=0,
                               atol=1e-6)
    dev = float(jax_wave[PIXEL] - jax_sweep[PIXEL])
    assert abs(dev) > 1e-3, dev
    np.testing.assert_allclose(abs(dev), JAX_DEVIATION, rtol=0.02)

    scene = build_scene(mount_scene(res=PIN_RES), device=torch.device("cpu"))
    port_wave = render_image(scene, RenderConfig(engine="wavefront")).numpy()
    err = np.abs(port_wave - jax_sweep)
    assert err.max() <= ATOL, (err.max(), np.unravel_index(err.argmax(),
                                                            err.shape))
    assert abs(float(port_wave[PIXEL] - jax_wave[PIXEL])) > 1e-3
