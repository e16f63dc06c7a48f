"""Nonlinear pose refinement on SE(3), fixed-iteration Gauss-Newton/LM.

JAX replacement for the reference's `scipy.optimize.least_squares`
pose refinement (SURVEY.md C12: refine the RANSAC-inlier pose by minimizing
spherical reprojection error [P1]). Idiomatic JAX: lift-solve-retract on the
SE(3) tangent, Jacobians by autodiff (jacfwd over the 6-dim tangent), a fixed
number of damped iterations inside `lax.fori_loop` -- no data-dependent
control flow, jits and vmaps cleanly (e.g. over batched sequences,
BASELINE.json:10).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sosvo.backend.schur import solve6x6_spd
from sosvo.geom.lie import se3_exp, transform_points


def bearing_residuals(T: jnp.ndarray, pts_prev: jnp.ndarray, rays_curr: jnp.ndarray) -> jnp.ndarray:
    """(N, 3) spherical reprojection residuals: direction(T X_prev) - ray_curr.

    The unit-vector difference is a well-conditioned small-angle proxy for the
    angular error (|d| = 2 sin(angle/2)) and keeps the residual smooth through
    autodiff (SURVEY.md C12 "spherical reprojection error").
    """
    pred = transform_points(T, pts_prev)
    d = pred / jnp.maximum(jnp.linalg.norm(pred, axis=-1, keepdims=True), 1e-9)
    return d - rays_curr


def refine_pose_bearings(
    T_init: jnp.ndarray,
    pts_prev: jnp.ndarray,
    rays_curr: jnp.ndarray,
    weights: jnp.ndarray,
    iters: int = 6,
    damping: float = 1e-4,
    huber_delta: float = 0.01,
) -> jnp.ndarray:
    """Refine T (curr-from-prev) so that T X_prev aligns with observed rays.

    IRLS with a Huber kernel on the per-point bearing residual norm: the
    previous frame's triangulated points carry depth errors growing ~ depth^2
    over the vertical baseline [P2], which the RANSAC inlier gate cannot
    fully remove; Huber keeps those heavy-tailed points from dragging the
    pose (reference's robust refinement stage, SURVEY.md C12).

    Args:
      T_init: (4, 4) initial relative pose (e.g. RANSAC output).
      pts_prev: (N, 3) triangulated points in the previous rig frame.
      rays_curr: (N, 3) observed unit rays in the current rig frame.
      weights: (N,) weights; zero = ignored slot (mask discipline).
      iters: fixed Gauss-Newton iteration count.
      damping: Levenberg lambda added to the normal equations.
      huber_delta: Huber kernel width on |bearing residual| (~rad).

    Returns:
      (4, 4) refined pose.
    """

    def step(_, T):
        # Closed-form Jacobian (equal to jacfwd of the lifted residual, see
        # tests/test_ba.py): with q = T p, d = q/|q|, left-perturbation
        # q(delta) = q + delta_v + delta_w x q gives
        #   J_k = w_k (I - d d^T)/|q| [ -[q]x | I ]   (tangent = (omega, v)).
        # Two exact identities collapse the normal equations to (N, 3)
        # elementwise math + three weighted-sum einsums -- no (N, 3, 3)
        # projector matmuls, no (3N, 6) Jacobian materialization:
        #   (I - d d^T) [q]x = [q]x          (d is parallel to q)
        # so with u = w/|q| the 3x3 blocks of H = J^T J are
        #   H_ww = sum u^2 (|q|^2 I - q q^T)
        #   H_wv = [sum u^2 q]x = -H_vw^T    (a hat of ONE summed vector)
        #   H_vv = sum u^2 (I - d d^T)
        # and g = (sum u w (q x r), sum u w (r - d (d.r))).
        q = transform_points(T, pts_prev)                     # (N, 3)
        nq = jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
        d = q / nq
        r = d - rays_curr
        nrm = jnp.linalg.norm(r, axis=-1)
        huber_w = jnp.sqrt(jnp.where(nrm <= huber_delta, 1.0,
                                     huber_delta / jnp.maximum(nrm, 1e-12)))
        w = weights * huber_w
        u = w / nq[:, 0]
        uw = u * w

        # ALL eight weighted reductions of the normal equations ride ONE
        # (14, N) x (N, 14) Gram matmul: columns are
        # [u*q | u*d | cross(q,r) | r - d(d.r) | u | uw], and every needed
        # moment is a block of C^T C --
        #   S_qq = (uq)^T(uq), S_dd = (ud)^T(ud), s1 = tr S_qq, s0 = u.u,
        #   m = (uq)^T u, g_w = cross^T uw, g_v = Y^T uw.
        # The iteration's critical path is the sequential dependent GN
        # steps, not the reduction count; the one contraction is kept for
        # the smaller jaxpr (vs 8 einsums per iteration).
        Y = r - d * jnp.sum(d * r, axis=-1, keepdims=True)
        C = jnp.concatenate([
            u[:, None] * q, u[:, None] * d, jnp.cross(q, r), Y,
            u[:, None], uw[:, None],
        ], axis=1)                                            # (N, 14)
        M = jax.lax.dot_general(
            C, C, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        S_qq = M[0:3, 0:3]
        S_dd = M[3:6, 3:6]
        s1 = S_qq[0, 0] + S_qq[1, 1] + S_qq[2, 2]
        s0 = M[12, 12]
        m = M[0:3, 12]
        g_w = M[6:9, 13]
        g_v = M[9:12, 13]
        eye3 = jnp.eye(3, dtype=T.dtype)
        zero = jnp.zeros_like(m[0])
        m_hat = jnp.stack([
            jnp.stack([zero, -m[2], m[1]], axis=-1),
            jnp.stack([m[2], zero, -m[0]], axis=-1),
            jnp.stack([-m[1], m[0], zero], axis=-1),
        ], axis=-2)
        H = jnp.block([[s1 * eye3 - S_qq, m_hat],
                       [-m_hat, s0 * eye3 - S_dd]]) + damping * jnp.eye(6, dtype=T.dtype)
        g = jnp.concatenate([g_w, g_v])
        delta = -solve6x6_spd(H, g)  # closed form; no LU loop
        return se3_exp(delta) @ T

    return jax.lax.fori_loop(0, iters, step, T_init)


def refine_pose_points(
    T_init: jnp.ndarray,
    pts_prev: jnp.ndarray,
    pts_curr: jnp.ndarray,
    weights: jnp.ndarray,
    iters: int = 4,
    damping: float = 1e-4,
    huber_delta: float = 0.05,
) -> jnp.ndarray:
    """Robust (Huber/IRLS) refinement of T on 3D-3D point residuals."""

    def residual_vec(delta, T, w):
        T_d = se3_exp(delta) @ T
        r = transform_points(T_d, pts_prev) - pts_curr
        return (r * w[:, None]).reshape(-1)

    def step(_, T):
        zero = jnp.zeros(6, dtype=T.dtype)
        r_raw = transform_points(T, pts_prev) - pts_curr
        nrm = jnp.linalg.norm(r_raw, axis=-1)
        huber_w = jnp.sqrt(jnp.where(nrm <= huber_delta, 1.0, huber_delta / jnp.maximum(nrm, 1e-9)))
        w = weights * huber_w
        J = jax.jacfwd(residual_vec)(zero, T, w)
        r = residual_vec(zero, T, w)
        H = J.T @ J + damping * jnp.eye(6, dtype=T.dtype)
        g = J.T @ r
        delta = -solve6x6_spd(H, g)  # closed form; no LU loop
        return se3_exp(delta) @ T

    return jax.lax.fori_loop(0, iters, step, T_init)
