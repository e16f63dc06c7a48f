"""Windowed bundle adjustment: Levenberg-Marquardt with Schur complement.

JAX replacement for the reference's nonlinear least-squares machinery
(SURVEY.md C13: scipy `least_squares` in the calibration path; the online VO
loop is frame-to-frame only [P1] -- windowed BA is mandated by the north star
BASELINE.json:5/8 "windowed bundle adjustment ... distributed BA via
Schur-complement reduction of camera/landmark blocks").

Design (idiomatic JAX, fixed shapes, SURVEY.md section 3.4):
  - The window is a DENSE fixed-size problem: W keyframe poses x L landmark
    slots x 2 views, with a (W, L, 2) weight mask selecting real observations.
    Sparsity is expressed by zero weights, not by ragged structure -- that is
    the move that lets the whole solver jit, scan, vmap, and shard.
  - Residuals are spherical (bearing) reprojections from BOTH omnistereo
    views; the vertical baseline between the two viewpoints pins metric scale
    (a single-view bearing-only window would be scale-gauge-free) [P2].
  - Block Jacobians (6 per pose, 3 per landmark) by autodiff (jacfwd over the
    SE(3) tangent + landmark position), vmapped over all (w, l) pairs.
  - The camera system is reduced by the Schur complement
        S = H_cc - H_cl H_ll^-1 H_lc,   b_red = b_c - H_cl H_ll^-1 b_l
    with per-landmark 3x3 inversions; landmark updates by back-substitution.
    The landmark-axis contractions live in `sosvo/backend/schur.py` so the
    distributed version can psum partial (S, b_red) over landmark shards.
  - LM damping with accept/reject inside `lax.scan` -- no Python control flow.

Gauge: the first keyframe is clamped by a large diagonal prior on its pose
block (and its update is zeroed exactly), so S stays well-posed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.backend.schur import (
    apply_pose_updates,
    back_substitute,
    inv3x3,
    reduce_camera_system,
)
from sosvo.geom.lie import se3_exp, transform_points

GAUGE_PRIOR = 1e8


class BAWindow(NamedTuple):
    """Fixed-size windowed BA problem (a pytree; vmap/shard-friendly).

    Attributes:
      X: (W, 4, 4) rig-from-world pose per keyframe (inverse of trajectory pose).
      landmarks: (L, 3) world-frame landmark positions.
      rays: (W, L, 2, 3) observed unit bearings, view 0 = top, 1 = bottom,
        in each keyframe's rig frame.
      weights: (W, L, 2) observation weights; 0 = no observation (mask).
      viewpoints: (2, 3) per-view viewpoint offsets in the rig frame
        (top at origin, bottom at -baseline z; SURVEY.md C4).
    """

    X: jnp.ndarray
    landmarks: jnp.ndarray
    rays: jnp.ndarray
    weights: jnp.ndarray
    viewpoints: jnp.ndarray


class BAResult(NamedTuple):
    X: jnp.ndarray           # (W, 4, 4) refined rig-from-world poses
    landmarks: jnp.ndarray   # (L, 3) refined landmarks
    cost: jnp.ndarray        # () final weighted SSE
    cost0: jnp.ndarray       # () initial weighted SSE
    accepted: jnp.ndarray    # (iters,) bool per-iteration step acceptance


def _pair_residual(X_w, p_l, rays_wl, w_wl, viewpoints):
    """(6,) weighted bearing residual of landmark l in keyframe w (2 views x 3).

    Normalization is `d * rsqrt(|d|^2 + eps)` -- smooth at d = 0 -- NOT
    `d / max(|d|, eps)`: `lax.max`'s JVP is multiply-based, so the NaN from
    d/dx |d| at 0 survives the max and poisons the (weight-0) Jacobian of
    every empty landmark slot seen from a keyframe sitting at a viewpoint.
    Trajectories start at the world origin (= the top viewpoint), so with the
    old form EVERY window containing keyframe 0 plus any unused landmark slot
    produced NaN normal equations and LM silently rejected all steps
    (tests/test_ba.py::test_ba_window_with_origin_keyframe_and_empty_slots).
    """
    p_rig = transform_points(X_w, p_l)
    d = p_rig[None, :] - viewpoints                     # (2, 3)
    d = d * jax.lax.rsqrt(jnp.sum(d * d, axis=-1, keepdims=True) + 1e-18)
    r = (d - rays_wl) * w_wl[:, None]                   # (2, 3)
    return r.reshape(6)


def _pair_jacobians(X_w, p_l, rays_wl, w_wl, viewpoints):
    """Residual + Jacobians wrt the pose tangent (6) and the landmark (3)."""

    def res(delta, p):
        return _pair_residual(se3_exp(delta) @ X_w, p, rays_wl, w_wl, viewpoints)

    zero = jnp.zeros(6, dtype=X_w.dtype)
    r = res(zero, p_l)
    J_pose, J_lm = jax.jacfwd(res, argnums=(0, 1))(zero, p_l)   # (6,6), (6,3)
    return r, J_pose, J_lm


def build_blocks(win: BAWindow, axis_name: str | None = None):
    """All BA normal-equation blocks, vmapped over the dense (W, L) grid.

    Under landmark sharding (`axis_name` set, inside shard_map over the
    "model" mesh axis; SURVEY.md P2-TP) the window's landmark axis holds only
    this device's shard: the landmark-indexed blocks (H_cl, H_ll, b_l) stay
    local, while the landmark-SUMMED quantities (H_cc, b_c, cost) are psummed
    so every device sees the global camera system.

    Returns:
      H_cc: (W, 6, 6) pose diagonal blocks (global).
      H_cl: (W, L, 6, 3) pose-landmark coupling blocks (local shard).
      H_ll: (L, 3, 3) landmark diagonal blocks (local shard).
      b_c:  (W, 6) pose gradient blocks (global).
      b_l:  (L, 3) landmark gradient blocks (local shard).
      cost: () weighted SSE (global).
    """
    f = jax.vmap(  # over landmarks
        jax.vmap(_pair_jacobians, in_axes=(None, 0, 0, 0, None)),  # l
        in_axes=(0, None, 0, 0, None),                              # w
    )
    r, J_pose, J_lm = f(win.X, win.landmarks, win.rays, win.weights, win.viewpoints)
    # r: (W, L, 6); J_pose: (W, L, 6, 6); J_lm: (W, L, 6, 3)
    H_cc = jnp.einsum("wlri,wlrj->wij", J_pose, J_pose)
    H_cl = jnp.einsum("wlri,wlrj->wlij", J_pose, J_lm)
    H_ll = jnp.einsum("wlri,wlrj->lij", J_lm, J_lm)
    b_c = jnp.einsum("wlri,wlr->wi", J_pose, r)
    b_l = jnp.einsum("wlri,wlr->li", J_lm, r)
    cost = 0.5 * jnp.sum(r * r)
    if axis_name is not None:
        H_cc = jax.lax.psum(H_cc, axis_name)
        b_c = jax.lax.psum(b_c, axis_name)
        cost = jax.lax.psum(cost, axis_name)
    return H_cc, H_cl, H_ll, b_c, b_l, cost


def ba_cost(win: BAWindow, axis_name: str | None = None) -> jnp.ndarray:
    """Weighted SSE of the window (no Jacobians; cheap accept/reject probe)."""
    f = jax.vmap(
        jax.vmap(_pair_residual, in_axes=(None, 0, 0, 0, None)),
        in_axes=(0, None, 0, 0, None),
    )
    r = f(win.X, win.landmarks, win.rays, win.weights, win.viewpoints)
    cost = 0.5 * jnp.sum(r * r)
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
    return cost


def huber_weights(win: BAWindow, delta: float) -> jnp.ndarray:
    """(W, L, 2) IRLS multipliers: sqrt-Huber on each observation's bearing
    residual norm. Robustifies BA against wrong data associations -- the
    image-mode map matcher has a nonzero outlier rate, and a single bad
    (landmark, keyframe) pair under plain L2 can drag the whole window
    (SURVEY.md C13; the reference's scipy path used soft-l1 losses [K])."""

    def per_pair(X_w, p_l, rays_wl, viewpoints):
        r = _pair_residual(X_w, p_l, rays_wl,
                           jnp.ones((2,), X_w.dtype), viewpoints).reshape(2, 3)
        return jnp.linalg.norm(r, axis=-1)                # (2,)

    f = jax.vmap(
        jax.vmap(per_pair, in_axes=(None, 0, 0, None)),
        in_axes=(0, None, 0, None),
    )
    nrm = f(win.X, win.landmarks, win.rays, win.viewpoints)  # (W, L, 2)
    return jnp.sqrt(jnp.where(nrm <= delta, 1.0, delta / jnp.maximum(nrm, 1e-12)))


def lm_step(win: BAWindow, lam: jnp.ndarray, axis_name: str | None = None,
            anchor: jnp.ndarray | int = 0):
    """One damped LM step: build blocks, Schur-reduce, solve, back-substitute.

    Returns the CANDIDATE updated window (caller decides accept/reject).
    Distributed (SURVEY.md section 3.4): landmark shards compute partial
    (S, b_red), psum over the "model" axis, every device solves the small
    replicated camera system identically, then back-substitutes its own
    landmark shard -- embarrassingly parallel.

    `anchor` is the gauge keyframe (may be traced -- the sliding window's
    ring buffer rotates which slot holds the oldest keyframe).
    """
    W = win.X.shape[0]
    H_cc, H_cl, H_ll, b_c, b_l, _ = build_blocks(win, axis_name)

    eye6 = jnp.eye(6, dtype=win.X.dtype)
    eye3 = jnp.eye(3, dtype=win.X.dtype)
    one_hot = (jnp.arange(W) == anchor).astype(win.X.dtype)
    # Damping/gauge are added AFTER the psum inside build_blocks, so they are
    # applied exactly once and identically on every shard.
    H_cc = H_cc + lam * eye6[None]
    # Gauge: clamp the anchor keyframe with a huge prior so the window is
    # anchored. Unobserved pose slots (all-zero rows) also get the prior so
    # the reduced system stays nonsingular.
    # Support detection must agree on every shard: H_cl holds only the local
    # landmark shard, so its contribution is psummed (b_c is already global).
    coupling = jnp.sum(jnp.abs(H_cl), axis=(1, 2, 3))
    if axis_name is not None:
        coupling = jax.lax.psum(coupling, axis_name)
    row_support = jnp.sum(jnp.abs(b_c), axis=-1) + coupling
    unobserved = (row_support == 0.0).astype(win.X.dtype)
    clamp = jnp.maximum(one_hot, unobserved)
    H_cc = H_cc + (GAUGE_PRIOR * clamp)[:, None, None] * eye6[None]

    H_ll_inv = inv3x3(H_ll + lam * eye3[None])  # (L, 3, 3) closed form
    S, b_red = reduce_camera_system(H_cc, H_cl, H_ll_inv, b_c, b_l, axis_name)

    # Dense solve of the reduced (6W, 6W) camera system -- cameras are few.
    S_flat = S.transpose(0, 2, 1, 3).reshape(6 * W, 6 * W)
    delta_c = -jnp.linalg.solve(S_flat, b_red.reshape(6 * W)).reshape(W, 6)
    delta_c = delta_c * (1.0 - clamp)[:, None]          # exact gauge clamp

    delta_l = back_substitute(H_ll_inv, H_cl, b_l, delta_c)  # (L, 3)

    X_new = apply_pose_updates(win.X, delta_c)
    lm_new = win.landmarks + delta_l
    return win._replace(X=X_new, landmarks=lm_new)


def ba_solve(win: BAWindow, iters: int = 5, lam0: float = 1e-3,
             axis_name: str | None = None, anchor: jnp.ndarray | int = 0,
             huber_delta: float | None = None) -> BAResult:
    """Levenberg-Marquardt with multiplicative damping adaptation.

    Accept a step iff it lowers the cost (then lam /= 3), else keep the old
    state and raise lam x 9 -- all inside lax.scan, fixed iteration count.
    With `axis_name`, runs landmark-sharded inside shard_map: the accept
    decision keys on the GLOBAL (psummed) cost, so all shards branch the same
    way -- replication consistency by construction.
    """
    cost0 = ba_cost(win, axis_name)
    lam = jnp.asarray(lam0, win.X.dtype)

    if axis_name is not None:
        # shard_map varying-manual-axes typing: psum outputs are typed as
        # varying over the axis, so after one iteration every carry leaf is
        # {V:axis}; cast the initial carry to match (values are unchanged).
        def _to_varying(a):
            a = jnp.asarray(a)
            if axis_name in getattr(jax.typeof(a), "vma", ()):
                return a  # already varying (e.g. the sharded landmark leaves)
            return jax.lax.pcast(a, axis_name, to="varying")

        win, lam, cost0 = jax.tree.map(_to_varying, (win, lam, cost0))

    def body(carry, _):
        w, lam, cost = carry
        if huber_delta is not None:
            # IRLS: freeze Huber multipliers at the current state; candidate
            # and current are compared under the SAME weights so the
            # accept/reject decision is consistent.
            hw = huber_weights(w, huber_delta)
            w_eff = w._replace(weights=w.weights * hw)
            cost = ba_cost(w_eff, axis_name)
        else:
            w_eff = w
        cand_w = lm_step(w_eff, lam, axis_name, anchor)
        cand = w._replace(X=cand_w.X, landmarks=cand_w.landmarks)
        cand_cost = ba_cost(cand._replace(weights=w_eff.weights), axis_name)
        accept = cand_cost < cost
        w_next = jax.tree.map(lambda a, b: jnp.where(accept, a, b), cand, w)
        lam_next = jnp.where(accept, lam / 3.0, lam * 9.0)
        lam_next = jnp.clip(lam_next, 1e-8, 1e4)
        cost_next = jnp.where(accept, cand_cost, cost)
        return (w_next, lam_next, cost_next), accept

    (w_fin, _, cost_fin), accepted = jax.lax.scan(
        body, (win, lam, cost0), None, length=iters
    )
    return BAResult(X=w_fin.X, landmarks=w_fin.landmarks, cost=cost_fin,
                    cost0=cost0, accepted=accepted)
