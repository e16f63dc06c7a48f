"""Image-sequence and trajectory IO (SURVEY.md C17).

The reference reads rig captures / POV-Ray renders with OpenCV and TUM-format
ground truth [P1/K]. Here sequences are stored as single .npz bundles
(pre-staged device-ready tensors beat per-frame image decode on the host --
SURVEY.md section 2.3) with optional TUM-format ground-truth import/export
for interop with standard evaluation tooling.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np


class Sequence(NamedTuple):
    images: np.ndarray | None   # (F, H, W) float32 raw omni frames (or None)
    poses: np.ndarray | None    # (F, 4, 4) ground-truth world-from-rig (or None)
    timestamps: np.ndarray      # (F,) float64 seconds


def save_sequence(path: str | Path, images=None, poses=None, timestamps=None) -> None:
    f = images if images is not None else poses
    assert f is not None, "need images or poses"
    n = len(f)
    ts = np.arange(n, dtype=np.float64) if timestamps is None else np.asarray(timestamps)
    arrays = {"timestamps": ts}
    if images is not None:
        arrays["images"] = np.asarray(images, np.float32)
    if poses is not None:
        arrays["poses"] = np.asarray(poses, np.float32)
    np.savez_compressed(path, **arrays)


def load_sequence(path: str | Path) -> Sequence:
    with np.load(path) as z:
        return Sequence(
            images=z["images"] if "images" in z else None,
            poses=z["poses"] if "poses" in z else None,
            timestamps=z["timestamps"],
        )


# ----------------------------------------------------------- TUM format

def save_tum_trajectory(path: str | Path, poses: np.ndarray, timestamps=None) -> None:
    """TUM format: `t tx ty tz qx qy qz qw` per line (world-from-rig)."""
    from sosvo.geom.lie import mat_to_quat  # wxyz
    import jax.numpy as jnp

    poses = np.asarray(poses)
    n = poses.shape[0]
    ts = np.arange(n, dtype=np.float64) if timestamps is None else np.asarray(timestamps)
    q = np.asarray(mat_to_quat(jnp.asarray(poses[:, :3, :3])))  # (F, 4) wxyz
    with open(path, "w") as f:
        for i in range(n):
            t = poses[i, :3, 3]
            f.write(f"{ts[i]:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} {q[i,0]:.6f}\n")


def load_tum_trajectory(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps (F,), poses (F, 4, 4))."""
    from sosvo.geom.lie import quat_to_mat
    import jax.numpy as jnp

    ts, poses = [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        v = [float(x) for x in line.split()]
        ts.append(v[0])
        T = np.eye(4, dtype=np.float32)
        # file order qx qy qz qw -> internal wxyz
        T[:3, :3] = np.asarray(quat_to_mat(jnp.asarray([v[7], v[4], v[5], v[6]])))
        T[:3, 3] = v[1:4]
        poses.append(T)
    return np.asarray(ts), np.stack(poses)
