"""Faults planted underneath a run's timed path, for the tests that see
``correct`` come out false (``python3 -m portbench.run ... --fault NAME``).

``planted(name)`` returns a function that edits the namespace of program
entry points a driver calls (its ``program()``), or the program's module
behind it, in the run's own process.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace


def _frame_stale(p):
    """The camera is never moved: every frame shows the first eye."""
    render, first = p.render_image, []

    def render_image(scene, cfg, *a, **k):
        if not first:
            first.append(scene.camera)
        return render(dataclasses.replace(scene, camera=first[0]), cfg,
                      *a, **k)

    p.render_image = render_image


def _frame_half(p):
    """Half of the pixels left out: the top half of the rows is black."""
    render = p.render_image

    def render_image(scene, cfg, *a, **k):
        img = render(scene, cfg, *a, **k).clone()
        img[img.shape[0] // 2:] = 0.0
        return img

    p.render_image = render_image


def _frame_altered(p):
    """Each frame's answer altered where it is produced: 10% darker."""
    render = p.render_image

    def render_image(scene, cfg, *a, **k):
        return render(scene, cfg, *a, **k) * 0.9

    p.render_image = render_image


def _with_step(p, wrap_run):
    d = p.dist
    make = d.make_train_step

    def make_train_step(*a, **k):
        return wrap_run(make(*a, **k))

    p.dist = SimpleNamespace(**{n: getattr(d, n) for n in dir(d)
                                if not n.startswith("__")})
    p.dist.make_train_step = make_train_step


def _step_unchanged(p):
    """A step that returns its state unchanged."""
    def wrap_run(run):
        def step(scene, target, generator=None):
            _, loss = run(scene, target, generator)
            return scene, loss
        return step
    _with_step(p, wrap_run)


def _step_altered(p):
    """The loss altered where it is produced: 1% high."""
    def wrap_run(run):
        def step(scene, target, generator=None):
            s, loss = run(scene, target, generator)
            return s, loss * 1.01
        return step
    _with_step(p, wrap_run)


def _step_half(p):
    """Half of the batch left out: each rank's loss over the first half of
    its pixels, the mean taken over that half."""
    d = p.dist

    def _image_loss(scene, target, cfg, g, group):
        from u_4a_2s_p3d_raytracer_template2_tpu_torch.models.whitted import (
            render_tile,
        )

        px, py, n, a = d._pixel_shard(scene.camera, scene.device, group)
        half = px.shape[0] // 2
        img = render_tile(scene, px[:half], py[:half], cfg, g)
        tgt = target.reshape(-1, 3)[a:a + half]
        return ((img - tgt) ** 2).sum() / float(n // 2)

    d._image_loss = _image_loss


def _step_no_exchange(p):
    """The exchange between ranks left out: each rank steps by its own
    share of the loss and gradients."""
    p.dist.all_reduce_sum = lambda tensors, group=None: list(tensors)


def _load_jax(p):
    """A module named ``jax`` loaded in the run's process."""
    import sys
    import types

    sys.modules["jax"] = types.ModuleType("jax")


FAULTS = {
    "load_jax": _load_jax,
    "frame_stale": _frame_stale, "frame_half": _frame_half,
    "frame_altered": _frame_altered, "step_unchanged": _step_unchanged,
    "step_half": _step_half, "step_altered": _step_altered,
    "step_no_exchange": _step_no_exchange,
}


def planted(name: str):
    return FAULTS[name]
