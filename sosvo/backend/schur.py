"""Schur-complement reduction primitives for windowed BA.

The landmark-axis contractions of BA's normal equations, factored into one
module because they are (a) the BA hot loop named by BASELINE.json:5, and
(b) the distribution point: under landmark sharding
(SURVEY.md P2-TP) every device computes `reduce_camera_system` over ITS
landmark shard and the partial (S, b_red) are combined with `jax.lax.psum`
(see `sosvo/dist/ba_dist.py`) -- the contraction is a sum over landmarks, so
sharding the l-axis and psumming is exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sosvo.geom.lie import se3_exp


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse via the adjugate ((..., 3, 3)).

    Pure elementwise arithmetic that XLA fuses into the Schur products,
    where `jnp.linalg.inv` would run a batched LU. Assumes well-conditioned
    (damped) inputs; no pivoting.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
        jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]


def solve6x6_spd(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (..., 6, 6) SPD solve via one 2x2-block Schur step.

    `jnp.linalg.solve` lowers a small LU loop; for the damped
    Gauss-Newton normal equations (SPD by construction) two adjugate 3x3
    inversions + a handful of matmuls solve exactly:

        [[A, B], [B^T, D]] x = g,  S = A - B D^-1 B^T,
        x1 = S^-1 (g1 - B D^-1 g2),  x2 = D^-1 (g2 - B^T x1).

    No pivoting -- callers must damp (the refine/BA paths add lambda*I).
    """
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    g1 = g[..., :3, None]
    g2 = g[..., 3:, None]
    Dinv = inv3x3(D)
    BDinv = B @ Dinv
    S = A - BDinv @ jnp.swapaxes(B, -1, -2)
    x1 = inv3x3(S) @ (g1 - BDinv @ g2)
    x2 = Dinv @ (g2 - jnp.swapaxes(B, -1, -2) @ x1)
    return jnp.concatenate([x1, x2], axis=-2)[..., 0]


def inv6x6_spd(H: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (..., 6, 6) SPD inverse (block Schur over `inv3x3`).

    For a constant preconditioner applied many times (e.g. block-Jacobi in
    PCG) inverting once beats re-running `jnp.linalg.solve`'s LU loop per
    application. Same damping contract as `solve6x6_spd`.
    """
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    Bt = jnp.swapaxes(B, -1, -2)
    Dinv = inv3x3(D)
    BDinv = B @ Dinv
    Sinv = inv3x3(A - BDinv @ Bt)
    TL = Sinv
    TR = -Sinv @ BDinv
    BL = jnp.swapaxes(TR, -1, -2)
    BR = Dinv - jnp.swapaxes(BDinv, -1, -2) @ TR
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, BR], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def reduce_camera_system(
    H_cc: jnp.ndarray,      # (W, 6, 6) pose diagonal blocks (damped, GLOBAL)
    H_cl: jnp.ndarray,      # (W, L, 6, 3) pose-landmark coupling (local shard)
    H_ll_inv: jnp.ndarray,  # (L, 3, 3) inverted landmark blocks (local shard)
    b_c: jnp.ndarray,       # (W, 6) (GLOBAL)
    b_l: jnp.ndarray,       # (L, 3) (local shard)
    axis_name: str | None = None,
):
    """Schur complement of the landmark blocks onto the camera system.

        S[w, w'] = delta_ww' H_cc[w] - sum_l H_cl[w,l] H_ll_inv[l] H_cl[w',l]^T
        b_red[w] = b_c[w] - sum_l H_cl[w,l] H_ll_inv[l] b_l[l]

    The einsums contract over the landmark axis l -- the axis that is sharded
    in distributed BA. With `axis_name` set (inside shard_map), the local
    partial subtraction terms are psummed BEFORE being combined with the
    already-global (H_cc, b_c), which is exactly the "Schur-complement
    reduction ... over jax.lax collectives" of BASELINE.json:5.

    Returns:
      S: (W, W, 6, 6) reduced camera Hessian (block layout, global).
      b_red: (W, 6) reduced gradient (global).
    """
    W = H_cc.shape[0]
    # A[w, l] = H_cl[w, l] @ H_ll_inv[l]  : (W, L, 6, 3)
    A = jnp.einsum("wlij,ljk->wlik", H_cl, H_ll_inv)
    S_off = jnp.einsum("wlik,vljk->wvij", A, H_cl)       # (W, W, 6, 6)
    b_sub = jnp.einsum("wlik,lk->wi", A, b_l)
    if axis_name is not None:
        S_off = jax.lax.psum(S_off, axis_name)
        b_sub = jax.lax.psum(b_sub, axis_name)
    eye_w = jnp.eye(W, dtype=H_cc.dtype)
    S = eye_w[:, :, None, None] * H_cc[:, None] - S_off
    b_red = b_c - b_sub
    return S, b_red


def back_substitute(
    H_ll_inv: jnp.ndarray,  # (L, 3, 3)
    H_cl: jnp.ndarray,      # (W, L, 6, 3)
    b_l: jnp.ndarray,       # (L, 3)
    delta_c: jnp.ndarray,   # (W, 6) solved pose updates
) -> jnp.ndarray:
    """Per-landmark update given the pose solution (embarrassingly parallel):

        delta_l[l] = -H_ll_inv[l] (b_l[l] + sum_w H_cl[w,l]^T delta_c[w])
    """
    rhs = b_l + jnp.einsum("wlij,wi->lj", H_cl, delta_c)
    return -jnp.einsum("lij,lj->li", H_ll_inv, rhs)


def apply_pose_updates(X: jnp.ndarray, delta_c: jnp.ndarray) -> jnp.ndarray:
    """Left-retract each pose: X[w] <- exp(delta_c[w]) X[w]. (W, 4, 4)."""
    return jnp.einsum("wij,wjk->wik", se3_exp(delta_c), X)
