"""The port's import graph holds no JAX, and its front end (CLI, PNG writer,
chip smoke script) works on the CPU."""
import os
import subprocess
import sys
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.cli\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.kernels\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted_megakernel\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.core.convert\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.timing\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.graphs\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.models.pathtracer\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.models.pt_megakernel\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.models.glsl_scene\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.sampling\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.glsl_hash\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.checkpoint\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.accel.packets\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.accel.sah\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.accel.bvh\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.accel.grid\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.accel.traverse\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.native\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted_wavefront\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.intersect\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.kernels.build\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.tools\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.probe_features\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.device_validate\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.roofline_mount\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.megakernels\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel.dist\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel.launch\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.entry\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.utils.profiling\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.io.image\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.ops.camera\n"
        "import u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build\n"
        "import chip_smoke, chip_faults\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'u_4a_2s_p3d_raytracer_template2_tpu'\n"
        "       or m.startswith('u_4a_2s_p3d_raytracer_template2_tpu.')]\n"
        "assert 'jax' not in sys.modules and not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        return  # the script's refusal is only observable without a card
    import chip_smoke  # its __main__ is sys.exit(main())

    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def _read_png(path):
    """Decode an 8-bit RGB PNG with filter 0 rows: [H, W, 3] u8, top row
    first."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        assert zlib.crc32(kind + body) == int.from_bytes(
            data[pos + 8 + n:pos + 12 + n], "big")
        if kind == b"IHDR":
            w = int.from_bytes(body[0:4], "big")
            h = int.from_bytes(body[4:8], "big")
            assert body[8:10] == b"\x08\x02"
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_save_png_flips_rows_and_quantizes(tmp_path):
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.image import (
        save_png,
        u8_from_float,
    )

    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, (5, 7, 3)).astype(np.float32)
    path = str(tmp_path / "a.png")
    save_png(path, torch.from_numpy(img))
    got = _read_png(path)
    np.testing.assert_array_equal(got, u8_from_float(img)[::-1])
    # Pillow, where present, reads the same pixels
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(path)), got)


def test_cli_render_cpu(tmp_path):
    from u_4a_2s_p3d_raytracer_template2_tpu_torch import cli
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.build import (
        build_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.core.types import (
        RenderConfig,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.image import (
        u8_from_float,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.scenes import (
        mount_scene,
    )
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
        render_image,
    )

    path = str(tmp_path / "m.png")
    assert cli.main(["render", "--builtin", "mount", "--res", "12",
                     "--depth", "3", "--engine", "megakernel", "--device",
                     "cpu", "-o", path]) == 0
    scene = build_scene(mount_scene(res=12), device=torch.device("cpu"))
    want = render_image(scene, RenderConfig(max_depth=3))
    np.testing.assert_array_equal(_read_png(path),
                                  u8_from_float(want.numpy())[::-1])


def test_cli_without_a_card_refuses_the_default_device(tmp_path, capsys):
    """No entry point drops to the CPU unless asked: without --device the
    CLI wants the card, and without one it exits naming --device cpu."""
    import pytest

    from u_4a_2s_p3d_raytracer_template2_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("the refusal is only observable without a card")
    for argv in (["render", "--res", "8"], ["pathtrace", "--res", "8"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv + ["-o", str(tmp_path / "x.png")])
        assert exc.value.code != 0
        assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()
