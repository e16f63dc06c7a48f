"""Calibration fitting: estimate unified-model parameters from observations.

JAX replacement for the reference's calibration toolchain (SURVEY.md
C16: GUM parameters fitted per mirror from chessboard/control-point
observations with scipy least_squares). Here: damped Gauss-Newton on the
reprojection residual with autodiff Jacobians, entirely jitted -- the
parameter vector is tiny (5 intrinsics per view [+ elevation band held
fixed], optional extrinsic z-offset), so the normal equations are solved
densely.

Observations: known 3D control points in the VIEW frame and their measured
pixels. The chessboard-pose-estimation outer loop of a full toolchain is out
of scope here (SURVEY.md C16 scope note); given per-view control points this
recovers the projection parameters to sub-millipixel on clean data.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.sensor.model import ViewParams, project

# Parameter vector layout:
# [xi, fx, fy, cx, cy, z_offset, k1, k2, p1, p2, mis_rx, mis_ry]
N_PARAMS = 12


def params_to_vector(v: ViewParams) -> jnp.ndarray:
    return jnp.stack([v.xi, v.fx, v.fy, v.cx, v.cy, v.z_offset,
                      v.k1, v.k2, v.p1, v.p2, v.mis_rx, v.mis_ry])


def vector_to_params(p: jnp.ndarray, template: ViewParams) -> ViewParams:
    return template._replace(xi=p[0], fx=p[1], fy=p[2], cx=p[3], cy=p[4],
                             z_offset=p[5], k1=p[6], k2=p[7], p1=p[8],
                             p2=p[9], mis_rx=p[10], mis_ry=p[11])


class CalibResult(NamedTuple):
    view: ViewParams
    rms_px: jnp.ndarray     # () residual RMS in pixels
    rms0_px: jnp.ndarray    # () initial RMS
    accepted: jnp.ndarray   # (iters,) LM acceptance trace


def _residuals(p: jnp.ndarray, template: ViewParams, pts_view: jnp.ndarray,
               uv_obs: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    view = vector_to_params(p, template)
    # The z_offset shifts the effective viewpoint along the axis.
    uv, _ = project(view, pts_view - jnp.array([0.0, 0.0, 1.0]) * (p[5] - template.z_offset))
    return ((uv - uv_obs) * w[:, None]).reshape(-1)


def fit_view(
    init: ViewParams,
    pts_view: jnp.ndarray,   # (N, 3) control points in the view frame
    uv_obs: jnp.ndarray,     # (N, 2) measured pixels
    weights: jnp.ndarray | None = None,
    iters: int = 20,
    lam0: float = 1e-2,
    fit_z_offset: bool = False,
    fit_distortion: bool = False,
    fit_misalignment: bool = False,
) -> CalibResult:
    """LM-fit one view's unified-model parameters to control points.

    `fit_distortion` frees (k1, k2, p1, p2); `fit_misalignment` frees
    (mis_rx, mis_ry) -- the full-GUM terms (SURVEY.md C3). Held at their
    initial values (usually zero) otherwise.
    """
    n = pts_view.shape[0]
    w = jnp.ones((n,), jnp.float32) if weights is None else weights
    p0 = params_to_vector(init)
    wsum = jnp.maximum(jnp.sum(w > 0), 1)

    # Mask: which parameters move.
    dist = 1.0 if fit_distortion else 0.0
    mis = 1.0 if fit_misalignment else 0.0
    move = jnp.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.0 if fit_z_offset else 0.0,
                      dist, dist, dist, dist, mis, mis])

    def rms(p):
        r = _residuals(p, init, pts_view, uv_obs, w).reshape(-1, 2)
        return jnp.sqrt(jnp.sum(r * r) / wsum)

    def body(carry, _):
        p, lam, cost = carry
        r = _residuals(p, init, pts_view, uv_obs, w)
        J = jax.jacfwd(_residuals)(p, init, pts_view, uv_obs, w)   # (2N, 6)
        J = J * move[None, :]
        H = J.T @ J + lam * jnp.eye(N_PARAMS)
        g = J.T @ r
        cand = p - jnp.linalg.solve(H, g) * move
        cand_cost = rms(cand)
        accept = cand_cost < cost
        p_next = jnp.where(accept, cand, p)
        lam_next = jnp.clip(jnp.where(accept, lam / 3.0, lam * 9.0), 1e-10, 1e6)
        return (p_next, lam_next, jnp.where(accept, cand_cost, cost)), accept

    cost0 = rms(p0)
    (p_fin, _, cost_fin), accepted = jax.lax.scan(
        body, (p0, jnp.asarray(lam0, jnp.float32), cost0), None, length=iters)
    return CalibResult(view=vector_to_params(p_fin, init), rms_px=cost_fin,
                       rms0_px=cost0, accepted=accepted)
