"""The port's sharded render (parallel/dist.render_image_sharded) on two
gloo ranks on the CPU (parallel/launch.run), against its unsharded
render_image and JAX's render_image_sharded on a mesh of 2 (the cases of
tests/test_parallel.py).

Each rank renders a contiguous slice of the pixels and one all_reduce
assembles the frame, so the sharded image equals the unsharded one bit for
bit, also where the pixel count is not a multiple of the ranks (23x23);
against JAX the repo's image rule holds (conftest.assert_images_close):
JAX's sharded render on a mesh of 2, rendered live at depth 2 and read at
depth 4 from tests/fixtures/dist_jax_refs.npz (tests/make_dist_fixture.py:
the depth-4 program compiles for about 20 s on an 8-core x86 host, the
depth-2 one for 11 s).
One spawn renders every case; its ranks import no JAX
(tests/torch_dist_workers.py).
"""
import numpy as np
import pytest
import torch

import u_4a_2s_p3d_raytracer_template2_tpu as jrt
from u_4a_2s_p3d_raytracer_template2_tpu.models.scenes import (
    mount_scene as jax_mount_scene,
)
from u_4a_2s_p3d_raytracer_template2_tpu.parallel import dist as jdist

from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
    render_image,
)
from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist, launch

import torch_dist_workers as workers
from conftest import assert_images_close
from make_dist_fixture import FIXTURE
from torch_parity import jax_reference, one_torch_thread  # noqa: F401

SPAWN_TIMEOUT_S = 90.0


@pytest.fixture(scope="module")
def sharded():
    """Rank 0's and rank 1's images of every case, from one spawn."""
    return launch.run(workers.render_rank, 2, timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def single():
    torch.set_num_threads(1)
    return {name: render_image(scene, cfg)
            for name, scene, cfg in workers.render_scenes()}


@pytest.mark.parametrize("name", ["mount16", "mount16_depth2",
                                  "sphere_plane23", "field16"])
def test_sharded_equals_unsharded(sharded, single, name):
    want = single[name]
    for rank, images in enumerate(sharded):
        got = images[name]
        assert got.shape == want.shape, (rank, got.shape)
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, want), (
            f"rank {rank}: max abs diff {(got - want).abs().max():.3g}")


def test_mount_against_jax_sharded(sharded):
    """JAX's render_image_sharded of mount_low 16x16, depth 2, on 2 of the
    8 virtual CPU devices."""
    mesh = jdist.default_mesh(2)
    jscene = jrt.build_scene(jax_mount_scene(res=16))
    want = jax_reference(
        lambda s: jdist.render_image_sharded(
            s, jrt.RenderConfig(max_depth=2), mesh), jscene)
    assert_images_close(sharded[0]["mount16_depth2"].numpy(), want)


def test_mount_depth4_against_jax_sharded(sharded):
    """JAX's render_image_sharded of mount_low 16x16, depth 4, default
    config, on a mesh of 2 (the fixture)."""
    want = np.load(FIXTURE)["render/mount16"]
    assert_images_close(sharded[1]["mount16"].numpy(), want)


def test_world_one_is_render_image(single):
    """Without a process group the call runs alone, issuing no
    collective."""
    name, scene, cfg = workers.render_scenes()[0]
    assert dist.world() == (0, 1)
    assert torch.equal(dist.render_image_sharded(scene, cfg), single[name])


@pytest.mark.parametrize("n,size", [(529, 2), (25, 2), (256, 3), (7, 8)])
def test_shard_bounds_are_tensor_split(n, size):
    want = [(int(p[0]), int(p[-1]) + 1) if len(p) else None
            for p in torch.tensor_split(torch.arange(n), size)]
    got = [dist.shard_bounds(n, size, r) for r in range(size)]
    assert [g if g[0] < g[1] else None for g in got] == want
    assert sum(b - a for a, b in got) == n


def test_rank_seeds_differ_and_are_stable():
    seeds = {dist.rank_seed(base, r) for base in (0, 1) for r in range(8)}
    assert len(seeds) == 16 and all(0 <= s < 2**63 for s in seeds)
    assert dist.rank_seed(0, 1) == dist.rank_seed(0, 1)
    g = torch.Generator().manual_seed(5)
    assert dist.rank_generator(g, 0, 1, "cpu") is g


def test_ranks_without_a_group_raise(monkeypatch):
    """Nothing runs alone by mistake: a named group, or WORLD_SIZE above 1,
    without torch.distributed initialised is an error."""
    with pytest.raises(RuntimeError, match="not initialised"):
        dist.world(group=object())
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        dist.world()
    assert dist.initialize_multihost(num_processes=1) is False
    assert dist.initialize_multihost() is False


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed first.*"
                       "planted failure on rank 1"):
        launch.run(workers.failing_rank, 2, timeout_s=SPAWN_TIMEOUT_S)


def test_a_hung_rank_is_killed():
    with pytest.raises(TimeoutError, match="still running"):
        launch.run(workers.sleeping_rank, 2, timeout_s=5.0)
