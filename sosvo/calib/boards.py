"""Chessboard-based rig calibration: the full C16 toolchain outer loop.

The reference's calibration toolchain (SURVEY.md C16: "fit GUM params per
mirror from chessboard/control points … scipy least_squares") alternates
between estimating board poses and refining mirror-model parameters. Here the
whole thing is ONE joint damped Gauss-Newton problem, entirely jitted:

  parameters  p = [intrinsics_top(5) | intrinsics_bottom(5) | baseline(1)
                   | board poses (M, 6) in SE(3) tangent coords]
  residuals   r = all weighted reprojection errors of the known board grid
                  through BOTH views of the omnistereo rig

Board poses are initialized without any PnP machinery by exploiting the
sensor itself: lift each corner observation to rays in both views,
stereo-triangulate (midpoint of the common perpendicular, SURVEY.md C8),
then Umeyama-align the known board grid to the triangulated cloud (C11).
That closed-form init is accurate enough for the joint GN to converge from
realistic intrinsic perturbations.

The problem is tiny (tens of parameters, thousands of residuals), so the
normal equations are formed densely and solved with `jnp.linalg.solve` —
the matmul-friendly shape is the (R, P) Jacobian matmul, which XLA fuses.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.geom.lie import se3_exp
from sosvo.geometry.align import umeyama
from sosvo.geometry.triangulate import midpoint_triangulate
from sosvo.sensor.model import ViewParams, lift, project, viewpoint
from sosvo.sensor.rig import OmnistereoRig

# Per-view intrinsic block layout:
# [xi, fx, fy, cx, cy, k1, k2, p1, p2, mis_rx, mis_ry]  (full GUM, r2)
N_INTR = 11


class BoardObservations(NamedTuple):
    """M boards × G grid corners observed through the omnistereo rig.

    Weights are 0 where a corner was not detected in that view (fixed-shape
    masking, as everywhere in this framework).
    """

    pts_board: jnp.ndarray   # (G, 3) known board-frame corner coordinates (z=0)
    uv_top: jnp.ndarray      # (M, G, 2) observed pixels in the top view
    w_top: jnp.ndarray       # (M, G) detection weights
    uv_bottom: jnp.ndarray   # (M, G, 2)
    w_bottom: jnp.ndarray    # (M, G)


class RigCalibResult(NamedTuple):
    rig: OmnistereoRig       # calibrated rig (elevation bands kept from init)
    poses: jnp.ndarray       # (M, 4, 4) rig-from-board transforms
    rms_px: jnp.ndarray      # () final reprojection RMS (pixels)
    rms0_px: jnp.ndarray     # () RMS at the initialization
    accepted: jnp.ndarray    # (iters,) LM step acceptance trace


def make_board_grid(nx: int = 8, ny: int = 6, square: float = 0.04) -> jnp.ndarray:
    """(nx*ny, 3) planar chessboard corner grid, centered, z = 0."""
    xs = (jnp.arange(nx) - (nx - 1) / 2.0) * square
    ys = (jnp.arange(ny) - (ny - 1) / 2.0) * square
    gx, gy = jnp.meshgrid(xs, ys, indexing="ij")
    return jnp.stack([gx.reshape(-1), gy.reshape(-1),
                      jnp.zeros(nx * ny)], axis=-1).astype(jnp.float32)


def init_board_poses(rig: OmnistereoRig, obs: BoardObservations) -> jnp.ndarray:
    """(M, 4, 4) closed-form rig-from-board inits via triangulate + Umeyama."""
    ray_t, ok_t = lift(rig.top, obs.uv_top)        # (M, G, 3)
    ray_b, ok_b = lift(rig.bottom, obs.uv_bottom)
    c_t = jnp.broadcast_to(viewpoint(rig.top), ray_t.shape)
    c_b = jnp.broadcast_to(viewpoint(rig.bottom), ray_b.shape)
    tri = midpoint_triangulate(ray_t, ray_b, c_t, c_b)
    w = (obs.w_top * obs.w_bottom
         * ok_t.astype(jnp.float32) * ok_b.astype(jnp.float32)
         * tri.valid.astype(jnp.float32))           # (M, G)
    src = jnp.broadcast_to(obs.pts_board, tri.points.shape)
    T, _ = umeyama(src, tri.points, weights=w)
    return T


def _unpack(p: jnp.ndarray, rig0: OmnistereoRig, n_boards: int):
    """Parameter vector → (top view, bottom view, (M,4,4) poses)."""
    it, ib = p[:N_INTR], p[N_INTR:2 * N_INTR]
    z_bot = p[2 * N_INTR]

    def view(v0: ViewParams, q, **extra):
        return v0._replace(xi=q[0], fx=q[1], fy=q[2], cx=q[3], cy=q[4],
                           k1=q[5], k2=q[6], p1=q[7], p2=q[8],
                           mis_rx=q[9], mis_ry=q[10], **extra)

    top = view(rig0.top, it)
    bottom = view(rig0.bottom, ib, z_offset=z_bot)
    tangents = p[2 * N_INTR + 1:].reshape(n_boards, 6)
    poses = jax.vmap(se3_exp)(tangents)
    return top, bottom, poses


def _pack(rig: OmnistereoRig, pose_tangents: jnp.ndarray) -> jnp.ndarray:
    def intr(v: ViewParams):
        return jnp.stack([v.xi, v.fx, v.fy, v.cx, v.cy, v.k1, v.k2,
                          v.p1, v.p2, v.mis_rx, v.mis_ry])
    return jnp.concatenate([intr(rig.top), intr(rig.bottom),
                            rig.bottom.z_offset[None],
                            pose_tangents.reshape(-1)])


def _residuals(p: jnp.ndarray, rig0: OmnistereoRig,
               obs: BoardObservations) -> jnp.ndarray:
    """All weighted reprojection residuals, flattened (4·M·G,)."""
    m = obs.uv_top.shape[0]
    top, bottom, poses = _unpack(p, rig0, m)
    # (M, G, 3) board corners in the rig frame.
    pts_rig = jnp.einsum("mij,gj->mgi", poses[:, :3, :3], obs.pts_board) \
        + poses[:, None, :3, 3]

    def view_res(view: ViewParams, uv_obs, w):
        uv, _ = project(view, pts_rig - viewpoint(view))
        return ((uv - uv_obs) * w[..., None]).reshape(-1)

    return jnp.concatenate([view_res(top, obs.uv_top, obs.w_top),
                            view_res(bottom, obs.uv_bottom, obs.w_bottom)])


def fit_rig_from_boards(
    rig0: OmnistereoRig,
    obs: BoardObservations,
    poses0: jnp.ndarray | None = None,
    iters: int = 30,
    lam0: float = 1e-2,
    fit_baseline: bool = True,
    fit_distortion: bool = False,
    fit_misalignment: bool = False,
    fit_xi: bool = True,
    huber_delta_px: float | None = None,
    mis_prior_px_per_rad: float | jnp.ndarray | None = None,
    mis_anchor: jnp.ndarray | None = None,
) -> RigCalibResult:
    """Joint LM over both views' intrinsics, the baseline, and board poses.

    `fit_distortion` / `fit_misalignment` free the full-GUM terms (k1, k2,
    p1, p2 / mis_rx, mis_ry) of BOTH views; frozen at their inits otherwise.
    `fit_xi=False` freezes the mirror parameter -- xi and radial distortion
    share a near-gauge over a finite elevation band, so fitting both from
    board data alone is ill-posed; freeze xi at its design/prior value when
    freeing distortion (`fit_rig_full_gum` does this).

    `huber_delta_px`: per-corner Huber IRLS scale in pixels. Real corner
    chains emit occasional gross outliers (a lattice cell grabbing a nearby
    spurious saddle moves a corner by 10+ px; measured in the calib->VO
    composition test), and staged fitting with still-frozen distortion sees
    legitimately huge far-annulus residuals -- under plain L2 either one can
    drag the fit into a wrong basin (measured: misalignment ran to ~-1.8 rad).
    IRLS weights are frozen per LM iteration; candidate and current cost are
    compared under the SAME weights (the `backend/ba.py` IRLS discipline).
    With robust weighting active, `rms_px`/`rms0_px` are the weighted rms
    (equal to the plain rms once all residuals are inside delta).

    `mis_prior_px_per_rad`: quadratic prior pulling each view's (mis_rx,
    mis_ry) toward its INITIALIZATION. The common mode of the two views'
    misalignment is a near-gauge: rotating both mirror axes together is
    almost a rigid rotation of the rig, which the free board poses absorb
    (measured: the unregularized fit parks ~0.12 rad of common-mode mis on
    both views at equal data cost). Mirrors are mechanically aligned to
    O(0.01 rad) by design [P2], so a weak prior resolves the gauge while
    leaving the observable differential misalignment data-driven.

    `mis_anchor`: (4,) [top_rx, top_ry, bot_rx, bot_ry] the prior pulls
    toward; defaults to THIS call's initialization. Staged recipes pass the
    ORIGINAL design values so an earlier stage's wrong mis estimate is not
    re-anchored as truth.
    """
    m = obs.uv_top.shape[0]
    if poses0 is None:
        poses0 = init_board_poses(rig0, obs)
    # SE(3) tangent init: log of the closed-form poses. se3_log exists in
    # geom.lie; import here to keep module top imports minimal.
    from sosvo.geom.lie import se3_log
    p0 = _pack(rig0, jax.vmap(se3_log)(poses0))
    n_params = p0.shape[0]

    # The baseline (bottom z_offset) is only observable with a metric board;
    # optionally freeze it (e.g. boards seen in one view only).
    move = jnp.ones((n_params,)).at[2 * N_INTR].set(1.0 if fit_baseline else 0.0)
    dist = 1.0 if fit_distortion else 0.0
    mis = 1.0 if fit_misalignment else 0.0
    gum = jnp.array([dist, dist, dist, dist, mis, mis])
    for base in (0, N_INTR):                       # top block, bottom block
        move = jax.lax.dynamic_update_slice(move, gum, (base + 5,))
        if not fit_xi:
            move = move.at[base + 0].set(0.0)

    n_obs = jnp.maximum(jnp.sum(obs.w_top > 0) + jnp.sum(obs.w_bottom > 0), 1)

    mis_idx = jnp.asarray([9, 10, N_INTR + 9, N_INTR + 10], jnp.int32)
    mis0 = p0[mis_idx] if mis_anchor is None else jnp.asarray(mis_anchor)

    def corner_sw(p):
        """(4MG/2,) sqrt-Huber IRLS multiplier per corner observation."""
        r = _residuals(p, rig0, obs).reshape(-1, 2)
        if huber_delta_px is None:
            return jnp.ones((r.shape[0],), r.dtype)
        nrm = jnp.linalg.norm(r, axis=-1)
        return jnp.sqrt(jnp.minimum(1.0, huber_delta_px / jnp.maximum(nrm, 1e-9)))

    def rms(p, sw):
        r = _residuals(p, rig0, obs).reshape(-1, 2) * sw[:, None]
        cost = jnp.sum(r * r)
        if mis_prior_px_per_rad is not None:
            d = (p[mis_idx] - mis0) * mis_prior_px_per_rad
            cost = cost + jnp.sum(d * d)
        return jnp.sqrt(cost / n_obs)

    def body(carry, _):
        p, lam, _ = carry
        sw = corner_sw(p)  # frozen for this iteration (IRLS)

        def wres(q):
            r = (_residuals(q, rig0, obs).reshape(-1, 2)
                 * sw[:, None]).reshape(-1)
            if mis_prior_px_per_rad is not None:
                r = jnp.concatenate(
                    [r, (q[mis_idx] - mis0) * mis_prior_px_per_rad])
            return r

        cost = rms(p, sw)
        r = wres(p)
        J = jax.jacfwd(wres)(p) * move[None, :]
        H = J.T @ J
        # Marquardt scaling: damp by the diagonal so pixels-vs-radians
        # parameter scales don't need hand conditioning.
        H = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-8))
        cand = p - jnp.linalg.solve(H, J.T @ r) * move
        cand_cost = rms(cand, sw)
        accept = cand_cost < cost
        p_next = jnp.where(accept, cand, p)
        lam_next = jnp.clip(jnp.where(accept, lam / 3.0, lam * 9.0), 1e-10, 1e6)
        return (p_next, lam_next, jnp.where(accept, cand_cost, cost)), accept

    cost0 = rms(p0, corner_sw(p0))
    (p_fin, _, cost_fin), accepted = jax.lax.scan(
        body, (p0, jnp.asarray(lam0, jnp.float32), cost0), None, length=iters)
    cost_fin = rms(p_fin, corner_sw(p_fin))
    top, bottom, poses = _unpack(p_fin, rig0, m)
    return RigCalibResult(rig=rig0._replace(top=top, bottom=bottom),
                          poses=poses, rms_px=cost_fin, rms0_px=cost0,
                          accepted=accepted)


def fit_rig_full_gum(rig0: OmnistereoRig, obs: BoardObservations,
                     iters: int = 30,
                     huber_delta_px: float | None = 2.0) -> RigCalibResult:
    """Staged full-GUM calibration: the recipe that converges in practice.

    Freeing all GUM terms at once from a zero init stalls in an xi/k1-coupled
    basin (measured: rms plateaus ~0.3 px with wrong terms), and fitting xi
    with unmodeled distortion drags xi far off (0.96 -> 0.78 measured) --
    xi and radial distortion share a near-gauge over a finite elevation band
    (a free xi lets k1/k2 wander while fitting the observations perfectly
    yet extrapolating 2 px off between sampled elevations). So xi stays
    FROZEN at its prior throughout, exactly as the mirror-design prior pins
    it in the published GUM calibrations [P2]: stage (1) fits pinhole
    intrinsics + misalignment, stages (2-3) add distortion. Reaches the
    noise floor (measured ~0.004 px on clean synthetic boards) with
    identifiable distortion/misalignment parameters.
    """
    hd = huber_delta_px

    # The prior anchors at the DESIGN misalignment (rig0's), not each
    # stage's possibly-wrong intermediate estimate.
    anchor = jnp.stack([rig0.top.mis_rx, rig0.top.mis_ry,
                        rig0.bottom.mis_rx, rig0.bottom.mis_ry])

    def staged(first_kw: dict) -> RigCalibResult:
        r1 = fit_rig_from_boards(rig0, obs, iters=iters, fit_xi=False,
                                 huber_delta_px=None if hd is None else 2 * hd,
                                 mis_prior_px_per_rad=30.0,
                                 mis_anchor=anchor, **first_kw)
        r2 = fit_rig_from_boards(r1.rig, obs, poses0=r1.poses, iters=iters,
                                 fit_distortion=True, fit_misalignment=True,
                                 fit_xi=False, huber_delta_px=hd,
                                 mis_prior_px_per_rad=30.0,
                                 mis_anchor=anchor)
        r3 = fit_rig_from_boards(r2.rig, obs, poses0=r2.poses,
                                 iters=iters + 10,
                                 fit_distortion=True, fit_misalignment=True,
                                 fit_xi=False, huber_delta_px=hd,
                                 mis_prior_px_per_rad=30.0,
                                 mis_anchor=anchor)
        # NOISE-ADAPTIVE final polish: the right prior strength scales with
        # the data's residual noise (a Bayesian prior against measurement
        # variance). Clean observations (rms ~ 1e-3 px) relax the prior so
        # the weakly-observable common-mode misalignment is data-driven
        # (measured recoverable to 2e-4 rad with 18 diverse boards); noisy
        # real-chain observations (rms ~ 2.5 px) keep it strong so outlier
        # corners cannot push the near-gauge mode off (measured runaway to
        # 0.07 rad at a weak fixed prior).
        w4 = jnp.clip(12.0 * r3.rms_px, 1.0, 100.0)
        r4 = fit_rig_from_boards(r3.rig, obs, poses0=r3.poses, iters=iters,
                                 fit_distortion=True, fit_misalignment=True,
                                 fit_xi=False, huber_delta_px=hd,
                                 mis_prior_px_per_rad=w4,
                                 mis_anchor=anchor)
        return r4._replace(rms0_px=r1.rms0_px)

    # MULTI-START over the stage-1 ordering; keep the lower final rms.
    # Mis-first converges on mild perturbations (the original recipe), but
    # with strong unmodeled radial distortion stage 1 absorbs the radial
    # field into misalignment and stalls in that basin (measured on the
    # calib->VO composition: mis ran to ~0.15 rad, fx off 8%); distortion-
    # first converges there and vice-versa stalls on the clean case
    # (measured 0.06 vs 0.004 px). Calibration is offline -- run both.
    ra = staged(dict(fit_distortion=True))
    rb = staged(dict(fit_misalignment=True))
    better_a = ra.rms_px <= rb.rms_px

    def pick(a, b):
        if not isinstance(a, jnp.ndarray):  # static leaves (image size ints)
            return a
        return jnp.where(better_a, a, b)

    return jax.tree.map(pick, ra, rb)
