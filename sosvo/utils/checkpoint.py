"""Checkpoint / resume of VO state as `.npz` files (SURVEY.md section 5.4).

The reference only dumps final trajectories + pickled calibration [K]; here
any replay is restartable: the full tracking pytree (pose, ring-buffered
keyframe window + landmark map, RNG key, frame index) snapshots every K
frames and a resumed run reproduces the uninterrupted trajectory exactly
(tested in tests/test_checkpoint.py, including a killed-process resume via
the CLI's --fault-inject).

A checkpoint is one `step_NNNNNNNN.npz` holding the pytree's leaves under
positional keys `leaf_0000`, `leaf_0001`, ...; the structure comes from the
template passed to `restore_state`, so field order never depends on key
sorting. The file is written under a temporary name and renamed, so a kill
mid-write leaves the previous checkpoint as the latest.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import jax
import numpy as np


def _path(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir).absolute() / f"step_{step:08d}.npz"


def save_state(ckpt_dir: str | Path, step: int, state: Any) -> Path:
    """Snapshot `state` (any pytree) at `step`; returns the checkpoint path."""
    path = _path(ckpt_dir, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = jax.tree.leaves(state)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i:04d}": np.asarray(a) for i, a in enumerate(leaves)})
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str | Path) -> int | None:
    p = Path(ckpt_dir)
    if not p.exists():
        return None
    steps = sorted(int(f.name[len("step_"):-len(".npz")])
                   for f in p.glob("step_*.npz"))
    return steps[-1] if steps else None


def restore_state(ckpt_dir: str | Path, step: int, template: Any) -> Any:
    """Restore the pytree saved at `step`, shaped like `template`."""
    flat_t, treedef = jax.tree.flatten(template)
    with np.load(_path(ckpt_dir, step)) as raw:
        if len(raw.files) != len(flat_t):
            raise ValueError(f"checkpoint has {len(raw.files)} leaves, "
                             f"template has {len(flat_t)}")
        restored = [
            jax.numpy.asarray(raw[f"leaf_{i:04d}"], dtype=t.dtype).reshape(t.shape)
            for i, t in enumerate(flat_t)
        ]
    return jax.tree.unflatten(treedef, restored)
