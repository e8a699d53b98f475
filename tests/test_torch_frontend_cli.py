"""The port's viewer commands (cli.py live, view and orbit) on the CPU at
16x16, held to the assertions of tests/test_cli_live.py: the key loop with
piped keys, the orbit steps, the ±85° pitch clamp and the 0.1 radius
floor, the accumulate-and-reset counts, the reset key, the half-block
preview and its off switch, and the PNGs."""
import io
import os
import re
import sys

import numpy as np
import pytest

from u_4a_2s_p3d_raytracer_template2_tpu_torch.cli import main
from u_4a_2s_p3d_raytracer_template2_tpu_torch.io.image import load_png

from torch_parity import one_torch_thread  # noqa: F401


def _run_live(keys, tmp_path, capsys, extra=()):
    out = str(tmp_path / "live.png")
    old = sys.stdin
    sys.stdin = io.StringIO(keys)
    try:
        main(["live", "--builtin", "mount", "--res", "16", "--preview-cols",
              "8", "--device", "cpu", "-o", out, *extra])
    finally:
        sys.stdin = old
    return out, capsys.readouterr().out


def test_live_orbit_accumulate_reset_and_png(tmp_path, capsys):
    # yaw left, pitch up, accumulate twice, yaw (resets), accumulate once
    out, text = _run_live("aw  a q", tmp_path, capsys)
    img = load_png(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    alphas = [float(m) for m in re.findall(r"alpha=\s*(-?[\d.]+)", text)]
    betas = [float(m) for m in re.findall(r"beta=\s*(-?[\d.]+)", text)]
    assert len(alphas) >= 3
    assert alphas[1] == pytest.approx(alphas[0] - 5.0)
    assert betas[2] == pytest.approx(min(betas[1] + 5.0, 85.0))
    accs = [int(m) for m in re.findall(r"accumulated (\d+) samples", text)]
    assert accs == [1, 2, 1]
    assert "\x1b[38;2;" in text and "▀" in text
    assert "FPS" in text and "Mrays/s" in text


def test_live_pitch_clamp_and_zoom_floor(tmp_path, capsys):
    out, text = _run_live("w" * 20 + "+" * 99 + "c q", tmp_path, capsys)
    betas = [float(m) for m in re.findall(r"beta=\s*(-?[\d.]+)", text)]
    assert max(betas) == pytest.approx(85.0)
    rs = [float(m) for m in re.findall(r" r=\s*(-?[\d.]+)", text)]
    assert min(rs) == pytest.approx(0.1, abs=1e-6)
    assert "Camera Spherical Coordinates" in text
    assert "Camera Cartesian Coordinates" in text


def test_live_reset_key(tmp_path, capsys):
    out, text = _run_live("aaaar q", tmp_path, capsys)
    alphas = [float(m) for m in re.findall(r"alpha=\s*(-?[\d.]+)", text)]
    assert alphas[-1] == pytest.approx(alphas[0])


def test_live_no_preview_flag(tmp_path, capsys):
    out, text = _run_live("q", tmp_path, capsys,
                          extra=("--preview-cols", "0"))
    assert "▀" not in text
    assert os.path.exists(out)


def test_view_session(tmp_path, capsys):
    out = str(tmp_path / "view.png")
    main(["view", "--builtin", "mount", "--res", "16", "--orbit-frames",
          "2", "--still-frames", "2", "--device", "cpu", "-o", out])
    text = capsys.readouterr().out
    assert load_png(out).shape == (16, 16, 3)
    assert len(re.findall(r"orbit frame \d: .* FPS .* Mrays/s", text)) == 2
    assert re.findall(r"still frame \d: (\d) samples", text) == ["1", "2"]


@pytest.mark.parametrize("tile_rows", [0, 5])
def test_orbit_frames(tmp_path, capsys, tile_rows):
    out = str(tmp_path / "orbit_%d.png")
    main(["orbit", "--builtin", "mount", "--res", "16", "--frames", "2",
          "--tile-rows", str(tile_rows), "--device", "cpu", "-o", out])
    frames = [load_png(str(tmp_path / f"orbit_{i}.png")) for i in range(2)]
    assert all(f.shape == (16, 16, 3) for f in frames)
    assert not np.array_equal(frames[0], frames[1])
