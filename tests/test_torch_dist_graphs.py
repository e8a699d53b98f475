"""The port's compiled sharded programs (parallel/dist.py on
utils/graphs.py) on two and three gloo ranks on the CPU, through the
stand-in graphs of tests/test_torch_graphs.py (``FakeGraphs``: a "capture"
runs the program, a "replay" runs it again into the static outputs),
installed inside each rank (tests/torch_dist_workers.compiled_rank).

Each rank runs every program in both of the port's modes: the collective
inside the captured program (NCCL's) and the collective after the replay
(gloo's on CUDA tensors). Held to:
  * the eager sharded calls bit for bit (``render_image_sharded_eager``,
    ``pt_frame_sharded_eager``, the eager train steps): on the CPU the
    arithmetic is the same;
  * JAX's sharded references in tests/fixtures/dist_jax_refs.npz under the
    tolerances tests/test_torch_dist_render.py and
    tests/test_torch_dist_train.py already use (mount_low 16x16, depth 4,
    the repo's image rule; the 8x8 train step, its loss to 1e-5 relative
    and each group's update to JAX's gradient tolerance).
The all-gather of the frame is held to the zero-filled all_reduce it
replaced (torch.equal: equal values; the all_reduce turns a -0 into +0).
One spawn a rank count; the ranks import no JAX. One process, about 15 s:

    python -m pytest -n 0 --durations=5 tests/test_torch_dist_graphs.py
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch

from u_4a_2s_p3d_raytracer_template2_tpu_torch.parallel import dist, launch

import torch_dist_workers as workers
from conftest import assert_images_close
from make_dist_fixture import FIXTURE, N_LEAVES
from torch_parity import one_torch_thread  # noqa: F401

REFS = np.load(FIXTURE)
SPAWN_TIMEOUT_S = 90.0
SIZES = (2, 3)
FRAMES = ("megakernel", "sweep")
# FitParams leaves by group, as tests/test_torch_dist_train.py
GROUPS = {"materials": range(0, 7), "light_pos": (7,), "light_color": (8,),
          "camera": (9, 10)}


def close(got, want, what):
    """JAX's gradient tolerance: max |a - b| <= 5e-3 max |a| + 1e-6."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max(initial=0.0)
    lim = 5e-3 * np.abs(want).max(initial=0.0) + 1e-6
    assert err <= lim, f"{what}: max abs err {err:.3g} over {lim:.3g}"


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"{n}ranks")
def ranks(request):
    """Every rank's readings (compiled_rank) from one spawn of this many
    ranks."""
    target = torch.from_numpy(REFS["train/target"])
    return launch.run(workers.compiled_rank, request.param, target,
                      timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("mode", workers.MODES)
@pytest.mark.parametrize("engine", FRAMES)
def test_compiled_frame_equals_eager_and_jax(ranks, mode, engine):
    """Two compiled calls on mount_low 16x16 and one on the orbited scene
    equal the eager sharded calls bit for bit on every rank; the first two
    hold JAX's sharded frame (the fixture's render/mount16)."""
    want_jax = REFS["render/mount16"]
    for rank, r in enumerate(ranks):
        f = r[mode][engine]
        for i, (got, want) in enumerate(zip(f["got"], f["want"])):
            assert torch.equal(got, want), (rank, i)
        assert not torch.equal(f["got"][0], f["got"][2])  # the orbit moved
        for got in f["got"][:2]:
            assert_images_close(got.numpy(), want_jax)


@pytest.mark.parametrize("mode", workers.MODES)
@pytest.mark.parametrize("engine", ["pt", "pt_plain"])
def test_compiled_path_tracer_frames_replay_the_eager_draws(ranks, mode,
                                                            engine):
    """Two compiled path-traced frames of one generator equal two eager
    sharded frames of one generator in the same state, bit for bit, and
    leave it where the eager frames leave it; the second frame draws
    anew; every rank holds the same frames."""
    for rank, r in enumerate(ranks):
        f = r[mode][engine]
        for i, (got, want) in enumerate(zip(f["got"], f["want"])):
            assert torch.equal(got, want), (rank, i)
            assert torch.equal(got, ranks[0][mode][engine]["got"][i])
        assert not torch.equal(f["got"][0], f["got"][1])
        assert torch.equal(*f["states"])


@pytest.mark.parametrize("mode", workers.MODES)
def test_compiled_train_step_full_against_jax(ranks, mode):
    """The compiled train_step_full of the fixture's 8x8 case: its first
    step within tests/test_torch_dist_train.py's tolerances of JAX's on a
    mesh of 2; both chained steps equal the eager sharded steps; the
    compiled train_step equals the eager one."""
    start = [x.numpy() for x in
             dist.tree_leaves(dist.params_of(workers.train_scene()))]
    want = [REFS[f"train/leaf_{i}"] for i in range(N_LEAVES)]
    for r in ranks:
        s = r[mode]["steps"]
        loss, leaves = s["got"][0]
        np.testing.assert_allclose(loss, float(REFS["train/loss"]),
                                   rtol=1e-5)
        for group, idx in GROUPS.items():
            got = np.concatenate([(leaves[i].numpy() - start[i]).ravel()
                                  for i in idx])
            ref = np.concatenate([(want[i] - start[i]).ravel() for i in idx])
            close(got, ref, f"{mode} {group} update")
        for (la, a), (lb, b) in zip(s["got"], s["want"]):
            assert la == lb
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert s["mat_got"][0] == s["mat_want"][0]
        assert all(torch.equal(x, y) for x, y in zip(s["mat_got"][1],
                                                     s["mat_want"][1]))


@pytest.mark.parametrize("mode", workers.MODES)
def test_each_program_is_one_graph_a_rank(ranks, mode):
    """No sharded call ran eagerly because a group exists: each program
    was captured once and replayed after; with the collective after the
    replay the graphs are the programs' local parts."""
    suffix = "" if mode == "in_graph" else ".local"
    names = {"dist.render_image_sharded": 2, "dist.pt_frame_sharded": 2,
             "dist.train_step_full": 1, "dist.train_step": 1}
    for r in ranks:
        got = {}
        for name, replays in r[mode]["graphs"]:
            got.setdefault(name, []).append(replays)
        assert {k: len(v) for k, v in got.items()} == {
            k + suffix: n for k, n in names.items()}
        assert r[mode]["captures"] == 6
        # each frame program three calls, each step program its calls
        assert sorted(got["dist.render_image_sharded" + suffix]) == [3, 3]
        assert sorted(got["dist.pt_frame_sharded" + suffix]) == [2, 2]
        assert got["dist.train_step_full" + suffix] == [2]


@pytest.mark.parametrize("n", workers.GATHER_SIZES)
def test_all_gather_equals_the_all_reduce(ranks, n):
    """The all-gather of every rank's slice, each padded to ceil(n / size)
    rows, equals the zero-filled all_reduce it replaced and the whole, on
    every rank (n = 25 leaves uneven slices on 2 and 3 ranks)."""
    for r in ranks:
        g = r["gathers"][n]
        assert torch.equal(g["all_gather"], g["all_reduce"])
        assert torch.equal(g["all_gather"], g["full"])
        assert torch.equal(g["gather_rows"], g["full"])


def test_a_rank_in_a_group_captures_thread_local(ranks, tmp_path):
    """A rank that joined its group through dist.join_group captures
    thread-local (the group's threads call CUDA during a capture);
    leave_group makes captures global again."""
    from u_4a_2s_p3d_raytracer_template2_tpu_torch.utils import graphs

    assert [r["capture_mode"] for r in ranks] == ["thread_local"] * len(ranks)
    assert graphs.CACHE.capture_mode == "global"
    dist.join_group("gloo", f"file://{tmp_path / 'rendezvous'}", 1, 0, "cpu",
                    SPAWN_TIMEOUT_S)
    try:
        assert graphs.CACHE.capture_mode == "thread_local"
    finally:
        dist.leave_group()
    assert graphs.CACHE.capture_mode == "global"


def test_nccl_with_more_ranks_than_cards_raises_before_spawning():
    """This host has no card, so any NCCL run has more ranks than cards:
    launch.run refuses it at once and starts no process."""
    before = set(multiprocessing.active_children())
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="NCCL ranks need 2 cards"):
        launch.run(workers.sleeping_rank, 2, backend="nccl",
                   timeout_s=SPAWN_TIMEOUT_S)
    assert time.monotonic() - t0 < 5.0
    assert set(multiprocessing.active_children()) == before
