"""Checkpoint / resume of a run's state; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/utils/checkpoint.py`` for its NumPy
``.npz`` format (the port has no orbax).

Two states are saved, each as the JAX package saves its pytree: the arrays
``arr_0``, ``arr_1``, ... in the pytree's flatten order, so a checkpoint
written by either package resumes in the other:

  * the path tracer's ``pathtracer.Accumulator`` (the GLSL feedback
    texture's running sum and sample count, P3D_RT.glsl:345-365):
    ``arr_0`` = ``sum_linear`` [H,W,3], ``arr_1`` = ``count`` [];
  * inverse rendering's ``parallel.dist.FitParams``: the seven material
    fields, then light positions, light colours, the camera's eye and
    focal ratio and the primitive table (``dist.tree_leaves``).

A checkpoint that does not match the target raises: a silently wrong resume
would blend unrelated state into the image or the fit.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.pathtracer import Accumulator
from ..parallel import dist

_ACC_LEAVES = ("sum_linear", "count")  # the JAX pytree's flatten order


def npz_path(path: str) -> str:
    """The file a checkpoint ``path`` names (``.npz`` appended if missing)."""
    return path if path.endswith(".npz") else path + ".npz"


def _leaves(state) -> list:
    if isinstance(state, Accumulator):
        return [getattr(state, f) for f in _ACC_LEAVES]
    if isinstance(state, dist.FitParams):
        return dist.tree_leaves(state)
    raise TypeError(f"no checkpoint layout for {type(state).__name__}")


def _unflatten(like, leaves):
    if isinstance(like, Accumulator):
        return Accumulator(**dict(zip(_ACC_LEAVES, leaves)))
    return dist.tree_unflatten(leaves)


def save(path: str, state) -> None:
    """Write ``state`` (an ``Accumulator`` or ``FitParams``) to
    ``npz_path(path)``; raises on write failure."""
    np.savez(npz_path(path), *[x.detach().cpu().numpy()
                               for x in _leaves(state)])


def restore(path: str, like):
    """Read a checkpoint into the structure, shapes and devices of ``like``
    (an ``Accumulator`` or ``FitParams``). Raises (naming the file) on a
    missing file, a wrong number of arrays or a wrong shape."""
    npz = npz_path(path)
    if not os.path.exists(npz):
        raise FileNotFoundError(f"no checkpoint at {path!r} ({npz})")
    want_leaves = _leaves(like)
    kind = type(like).__name__
    with np.load(npz) as data:
        if len(data.files) != len(want_leaves):
            raise ValueError(
                f"checkpoint {npz!r} has {len(data.files)} arrays but the "
                f"target {kind} has {len(want_leaves)} — wrong or corrupt "
                "checkpoint")
        restored = []
        for i, want in enumerate(want_leaves):
            key = f"arr_{i}"
            arr = data[key]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint {npz!r} leaf {i} ({key}) has shape "
                    f"{arr.shape}, target expects {tuple(want.shape)}")
            restored.append(torch.from_numpy(
                np.array(arr, np.float32)).to(want.device))
    return _unflatten(like, restored)
