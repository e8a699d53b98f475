"""Checkpoint / resume of progressive path-tracing state; the counterpart of
``u_4a_2s_p3d_raytracer_template2_tpu/utils/checkpoint.py`` for its NumPy
``.npz`` format (the port has no orbax).

The state is the ``pathtracer.Accumulator`` (the GLSL feedback texture's
running sum and sample count, P3D_RT.glsl:345-365), stored as the JAX package
stores it: ``arr_0`` = ``sum_linear`` [H,W,3], ``arr_1`` = ``count`` [], so a
checkpoint written by either package resumes in the other. A checkpoint that
does not match the target raises: a silently wrong resume would blend
unrelated accumulation state into the image.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.pathtracer import Accumulator

_LEAVES = ("sum_linear", "count")  # the JAX pytree's flatten order


def npz_path(path: str) -> str:
    """The file a checkpoint ``path`` names (``.npz`` appended if missing)."""
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, acc: Accumulator) -> None:
    """Write ``acc`` to ``npz_path(path)``; raises on write failure."""
    np.savez(npz_path(path), *[getattr(acc, f).detach().cpu().numpy()
                               for f in _LEAVES])


def restore(path: str, like: Accumulator) -> Accumulator:
    """Read a checkpoint into the shapes and device of ``like``. Raises
    (naming the file) on a missing file, a wrong number of arrays or a
    wrong shape."""
    npz = npz_path(path)
    if not os.path.exists(npz):
        raise FileNotFoundError(f"no checkpoint at {path!r} ({npz})")
    with np.load(npz) as data:
        if len(data.files) != len(_LEAVES):
            raise ValueError(
                f"checkpoint {npz!r} has {len(data.files)} arrays but an "
                f"Accumulator has {len(_LEAVES)} — wrong or corrupt "
                "checkpoint")
        restored = {}
        for i, field in enumerate(_LEAVES):
            key = f"arr_{i}"
            want = getattr(like, field)
            arr = data[key]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint {npz!r} leaf {i} ({key}) has shape "
                    f"{arr.shape}, target expects {tuple(want.shape)}")
            restored[field] = torch.from_numpy(
                np.array(arr, np.float32)).to(want.device)
    return Accumulator(**restored)
