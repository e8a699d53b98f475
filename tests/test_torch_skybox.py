"""The port's skybox against the JAX package's: the cubemap lookup, the PNG
and face loaders, scenes with an ``env`` line, and renders whose misses read
the sky.

Indices, texel colors, decoded images and loaded cubemaps are held equal
(atol 0: the same f32 operations on the same inputs). Renders are held to
the repo's image rule, ``assert_images_close`` (atol 2e-3 on all but 1% of
pixels).
"""
import dataclasses
import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as rt
import u_4a_2s_p3d_raytracer_template2_tpu_torch as pt
from u_4a_2s_p3d_raytracer_template2_tpu.io import image as jimage
from u_4a_2s_p3d_raytracer_template2_tpu.io import skybox as jskybox
from u_4a_2s_p3d_raytracer_template2_tpu.models.whitted import (
    render_tile as jax_render_tile,
)
from u_4a_2s_p3d_raytracer_template2_tpu.ops import shade as jshade
from u_4a_2s_p3d_raytracer_template2_tpu_torch.io import image as pimage
from u_4a_2s_p3d_raytracer_template2_tpu_torch.io import skybox as pskybox
from u_4a_2s_p3d_raytracer_template2_tpu_torch.models import scenes
from u_4a_2s_p3d_raytracer_template2_tpu_torch.ops import shade as pshade
from conftest import assert_images_close
from test_megakernel import _test_skybox
from torch_parity import (  # one_torch_thread: an autouse fixture
    jax_reference,
    jax_scene_to_port,
    mixed_scene,
    one_torch_thread,
)

CPU = torch.device("cpu")


def _directions(n=4096, seed=0):
    """Seeded directions with the corner cases of the dominant-axis rule:
    |x| = |y| ties, |z| equal to the larger of them, zero components, the
    zero vector, and both signs of every axis."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = n // 8
    d[:k, 1] = d[:k, 0] * rng.choice([-1, 1], k)               # |x| = |y|
    d[k:2 * k, 2] = np.abs(d[k:2 * k, :2]).max(1) * rng.choice([-1, 1], k)
    d[2 * k:3 * k, rng.integers(0, 3)] = 0.0                    # a zero axis
    d[3 * k:3 * k + 8] = 0.0                                    # zero vectors
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d[3 * k + 8:3 * k + 14] = axes                              # +-x, +-y, +-z
    d[4 * k:5 * k] = np.sign(d[4 * k:5 * k])                    # all ties
    return d


@pytest.mark.parametrize("H,W", [(8, 8), (2048, 2048), (5, 7)])
def test_cubemap_index_equals_jax(H, W):
    d = _directions()
    want = [np.asarray(a) for a in jshade.cubemap_index(jnp.asarray(d), H, W)]
    got = [a.numpy() for a in pshade.cubemap_index(torch.from_numpy(d), H,
                                                    W)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(np.unique(got[0])) == set(range(6))


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_skybox_color_equals_jax(kind):
    rng = np.random.default_rng(1)
    sky = rng.integers(0, 256, (6, 9, 11, 3)).astype(np.uint8)
    if kind == "f32":
        sky = sky.astype(np.float32) / 255.0
    d = _directions(seed=2)
    valid = rng.random(d.shape[0]) < 0.7
    for v in (None, valid):
        want = np.asarray(jshade.skybox_color(
            jnp.asarray(sky), jnp.asarray(d),
            valid=None if v is None else jnp.asarray(v)))
        got = pshade.skybox_color(
            torch.from_numpy(sky), torch.from_numpy(d),
            valid=None if v is None else torch.from_numpy(v)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _png_with_filter(img: np.ndarray, kind: int) -> bytes:
    """An 8-bit PNG of ``img`` [H, W, C] with every scanline filtered by
    filter ``kind`` (PNG spec section 9), so the decoder's unfilter is
    tested on each type."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        prev = x[y - 1] if y else np.zeros(w * c, np.int32)
        a = np.concatenate([np.zeros(c, np.int32), x[y, :-c]])
        cprev = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            f = x[y]
        elif kind == 1:
            f = x[y] - a
        elif kind == 2:
            f = x[y] - prev
        elif kind == 3:
            f = x[y] - (a + prev) // 2
        else:
            p = a + prev - cprev
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - cprev)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, cprev))
            f = x[y] - pred
        rows.append(np.concatenate([[kind], f & 0xFF]).astype(np.uint8))
    raw = np.stack(rows).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = {3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_png_equals_pillow(tmp_path, channels):
    from PIL import Image

    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (7, 13, channels)).astype(np.uint8)
    for kind in range(5):
        path = tmp_path / f"f{kind}.png"
        path.write_bytes(_png_with_filter(img, kind))
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(pimage.decode_png(str(path)), want)
        np.testing.assert_array_equal(img[..., :3], want)


def test_load_png_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.random((9, 14, 3)).astype(np.float32)
    path = str(tmp_path / "img.png")
    pimage.save_png(path, img)
    got = pimage.load_png(path)
    np.testing.assert_array_equal(got, jimage.load_png(path))
    assert got.shape == (9, 14, 3)  # row 0 is the bottom, as saved


@pytest.fixture
def faces():
    return scenes.synthetic_skybox(16, seed=4)


@pytest.mark.parametrize("pillow", [True, False])
def test_load_skybox_dir_equals_jax(tmp_path, monkeypatch, faces, pillow):
    pskybox.save_skybox_dir(str(tmp_path), faces)
    want = jskybox.load_skybox_dir(str(tmp_path))
    if not pillow:
        monkeypatch.setitem(sys.modules, "PIL", None)  # import raises
    got = pskybox.load_skybox_dir(str(tmp_path))
    assert got.dtype == np.uint8 and got.shape == (6, 16, 16, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, faces)


def test_load_skybox_dir_degrades_to_none(tmp_path, monkeypatch, faces):
    assert pskybox.load_skybox_dir(str(tmp_path / "missing")) is None
    pskybox.save_skybox_dir(str(tmp_path), faces)
    os.remove(tmp_path / "back.png")
    assert pskybox.load_skybox_dir(str(tmp_path)) is None
    assert jskybox.load_skybox_dir(str(tmp_path)) is None
    # a JPEG face needs a decoder: without Pillow, no skybox
    from PIL import Image

    Image.fromarray(faces[5]).save(tmp_path / "back.jpg")
    assert pskybox.load_skybox_dir(str(tmp_path)).shape == (6, 16, 16, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert pskybox.load_skybox_dir(str(tmp_path)) is None


def test_env_scene_builds_as_in_jax(tmp_path, faces):
    """A SceneDef with an ``env`` line builds in both packages, with or
    without the directory; jax_scene_to_port carries the cubemap."""
    for env, has in ((str(tmp_path / "missing"), False),
                     (str(tmp_path / "sky"), True)):
        if has:
            pskybox.save_skybox_dir(env, faces)
        psd, jsd = scenes.mount_scene(res=8), scenes.mount_scene(res=8)
        psd.skybox_dir = jsd.skybox_dir = env
        port = pt.build_scene(psd, device=CPU)
        jscene = rt.build_scene(jsd)
        assert port.has_skybox == jscene.has_skybox == has
        carried = jax_scene_to_port(jscene)
        assert carried.has_skybox == has
        if has:
            for s in (port, carried):
                assert s.skybox.dtype == torch.uint8
                np.testing.assert_array_equal(s.skybox.numpy(),
                                              np.asarray(jscene.skybox))
        else:
            assert port.skybox is None and carried.skybox is None
    f32 = dataclasses.replace(jscene, skybox=_test_skybox(), has_skybox=True)
    assert jax_scene_to_port(f32).skybox.dtype == torch.float32


@pytest.mark.parametrize("kind", ["f32", "u8"])
def test_skybox_render_matches_jax(kind):
    """Misses read the cubemap at every level of a refl+refr tree:
    _test_skybox's smooth 8x8 f32 recipe (tests/test_megakernel.py:30-43),
    and a random u8 cubemap; the sweep and the megakernel's plain
    version."""
    res = 16
    if kind == "f32":
        sky = _test_skybox()
    else:
        sky = jnp.asarray(np.random.RandomState(7).randint(
            0, 256, (6, 8, 8, 3)).astype(np.uint8))
    jscene = dataclasses.replace(rt.build_scene(mixed_scene(rt.SceneDef(),
                                                            res=res)),
                                 skybox=sky, has_skybox=True)
    cfg = rt.RenderConfig(max_depth=3, use_skybox=True)
    ys, xs = np.meshgrid(np.arange(res, dtype=np.float32),
                         np.arange(res, dtype=np.float32), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    want = jax_reference(
        lambda x, y: jax_render_tile(jscene, x, y, cfg,
                                     jax.random.PRNGKey(0)),
        jnp.asarray(px), jnp.asarray(py)).reshape(res, res, 3)
    port = jax_scene_to_port(jscene)
    for engine in ("sweep", "megakernel"):
        got = pt.render_image(port, pt.RenderConfig(max_depth=3,
                                                    use_skybox=True,
                                                    engine=engine))
        assert_images_close(got.numpy(), want)
    flat = pt.render_image(port, pt.RenderConfig(max_depth=3))
    assert float((flat - got).abs().max()) > 0.05  # the sky shows
