"""Checkpoint / resume helpers (PyTorch port of the JAX package's
``utils/checkpoint.py``).

The reference has no persistence at all (its solves are sub-second and
stateless); the cheap host-side state worth keeping is:

- a built :class:`~..pipelines.ndt.NdtMap` (the expensive part of the
  pipeline on large clouds);
- registration progress between outer ICP iterations (pose + iteration
  counters + per-iteration costs), so a long mapping session can resume.

Format: a single ``.npz`` per object, plain numpy, no pickling. The keys
and the ``kind`` tag are the JAX package's, so a file written by either
package loads in the other.
"""

from __future__ import annotations

import numpy as np

from ..core.pose import Pose
from ..pipelines.ndt import NdtMap


def save_ndt_map(path: str, ndt_map: NdtMap) -> None:
    np.savez_compressed(
        path,
        kind="ndt_map",
        means=ndt_map.means,
        sqrt_informations=ndt_map.sqrt_informations,
        informations=ndt_map.informations,
        counts=ndt_map.counts,
        valid=ndt_map.valid,
    )


def load_ndt_map(path: str) -> NdtMap:
    with np.load(path, allow_pickle=False) as z:
        if str(z["kind"]) != "ndt_map":
            raise ValueError(f"{path} is not an NDT map checkpoint")
        return NdtMap(
            means=z["means"],
            sqrt_informations=z["sqrt_informations"],
            informations=z["informations"],
            counts=z["counts"],
            valid=z["valid"],
        )


def save_pose(path: str, pose: Pose, **extra_arrays) -> None:
    """Persist a pose plus arbitrary named numpy arrays (iteration
    counters, cost traces, lambda, ...)."""
    np.savez_compressed(
        path,
        kind="pose_state",
        rotation=pose.rotation,
        translation=pose.translation,
        **{k: np.asarray(v) for k, v in extra_arrays.items()},
    )


def load_pose(path: str):
    """Returns (pose, dict_of_extra_arrays)."""
    with np.load(path, allow_pickle=False) as z:
        if str(z["kind"]) != "pose_state":
            raise ValueError(f"{path} is not a pose checkpoint")
        pose = Pose(z["rotation"], z["translation"])
        extras = {
            k: z[k]
            for k in z.files
            if k not in ("kind", "rotation", "translation")
        }
        return pose, extras
