"""Trajectory evaluation: ATE and RPE, TUM-benchmark style.

JAX replacement for the reference's evaluation layer (SURVEY.md C18:
TUM-style ATE/RPE scripts against Vicon / synthetic ground truth [P1/K]).
This produces the headline metric of BASELINE.json:2 ("ATE RMSE (m)").

Definitions (BASELINE.md "Metrics"):
  * ATE RMSE: align estimated to ground-truth trajectory with a single
    closed-form SE(3) (optionally Sim(3)) Horn/Umeyama fit over the
    positions, then RMSE of residual position error over frames.
  * RPE: per-frame relative-pose error over a fixed frame delta; reported as
    RMSE of translational drift and rotational drift.
"""

from __future__ import annotations

import jax.numpy as jnp

from sosvo.geom.lie import geodesic_angle, mat_inv
from sosvo.geometry.align import umeyama


def ate_rmse(est_positions: jnp.ndarray, gt_positions: jnp.ndarray, with_scale: bool = False):
    """Absolute trajectory error RMSE after Horn alignment.

    Args:
      est_positions: (F, 3) estimated camera positions.
      gt_positions: (F, 3) ground-truth positions.
      with_scale: align with Sim(3) (for scale-free 2D-2D mode, BASELINE.md).

    Returns:
      rmse: scalar ATE RMSE in meters.
      T_align: (4, 4) alignment transform mapping est -> gt.
    """
    T, scale = umeyama(est_positions, gt_positions, with_scale=with_scale)
    aligned = est_positions @ T[:3, :3].T + T[:3, 3]
    err = aligned - gt_positions
    rmse = jnp.sqrt(jnp.mean(jnp.sum(err * err, axis=-1)))
    return rmse, T


def rpe(est_poses: jnp.ndarray, gt_poses: jnp.ndarray, delta: int = 1):
    """Relative pose error at frame spacing `delta`.

    Args:
      est_poses: (F, 4, 4) estimated world-from-camera poses.
      gt_poses: (F, 4, 4) ground-truth poses.

    Returns:
      trans_rmse: RMSE of relative translation error (m).
      rot_rmse: RMSE of relative rotation error (radians).
    """
    a0, a1 = est_poses[:-delta], est_poses[delta:]
    g0, g1 = gt_poses[:-delta], gt_poses[delta:]
    rel_est = mat_inv(a0) @ a1
    rel_gt = mat_inv(g0) @ g1
    err = mat_inv(rel_gt) @ rel_est
    trans = jnp.linalg.norm(err[..., :3, 3], axis=-1)
    rot = geodesic_angle(jnp.broadcast_to(jnp.eye(3), err[..., :3, :3].shape), err[..., :3, :3])
    return jnp.sqrt(jnp.mean(trans**2)), jnp.sqrt(jnp.mean(rot**2))
