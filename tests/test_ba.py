"""Windowed BA: convergence on synthetic windows with exact ground truth.

SURVEY.md section 4.1/4.2: synthetic observations from known poses/landmarks,
perturb, solve, and require recovery to tight tolerance (the golden-test
strategy inherited from the reference's exact-ground-truth validation).
"""

import jax
import jax.numpy as jnp
import numpy as np

from sosvo.backend.ba import BAWindow, ba_cost, ba_solve
from sosvo.geom.lie import mat_inv, se3_exp, transform_points
from sosvo.sensor.model import viewpoint
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene

W, L = 5, 128


def _make_window(key, pose_noise=0.0, lm_noise=0.0, pixel_like_noise=0.0):
    """Exact two-view bearing observations of L landmarks from W keyframes."""
    rig = default_rig()
    scene = make_scene(key, n_frames=W, n_landmarks=4096)
    lms = scene.landmarks[:L]
    X_gt = jax.vmap(mat_inv)(scene.poses)               # rig-from-world
    vps = jnp.stack([viewpoint(rig.top), viewpoint(rig.bottom)])

    p_rig = jax.vmap(lambda X: transform_points(X, lms))(X_gt)   # (W, L, 3)
    d = p_rig[:, :, None, :] - vps[None, None]                   # (W, L, 2, 3)
    rays = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    if pixel_like_noise > 0.0:
        k1, key = jax.random.split(key)
        rays = rays + pixel_like_noise * jax.random.normal(k1, rays.shape)
        rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
    weights = jnp.ones((W, L, 2), jnp.float32)

    k2, k3 = jax.random.split(jax.random.fold_in(key, 7))
    # Perturb every pose except keyframe 0 (the gauge anchor) + all landmarks.
    xi = pose_noise * jax.random.normal(k2, (W, 6))
    xi = xi.at[0].set(0.0)
    X0 = jnp.einsum("wij,wjk->wik", se3_exp(xi), X_gt)
    lms0 = lms + lm_noise * jax.random.normal(k3, lms.shape)

    win = BAWindow(X=X0, landmarks=lms0, rays=rays, weights=weights, viewpoints=vps)
    return win, X_gt, lms


def test_ba_zero_residual_at_ground_truth():
    win, X_gt, lms = _make_window(jax.random.PRNGKey(0))
    assert float(ba_cost(win)) < 1e-8


def test_ba_recovers_perturbed_window():
    win, X_gt, lms = _make_window(jax.random.PRNGKey(1), pose_noise=0.02, lm_noise=0.03)
    res = jax.jit(lambda w: ba_solve(w, iters=8))(win)
    assert float(res.cost) < 1e-7, float(res.cost)
    # Poses recovered (gauge anchored at kf0 ground truth).
    t_err = jnp.linalg.norm(res.X[:, :3, 3] - X_gt[:, :3, 3], axis=-1)
    assert float(jnp.max(t_err)) < 1e-3, np.asarray(t_err)
    lm_err = jnp.linalg.norm(res.landmarks - lms, axis=-1)
    assert float(jnp.median(lm_err)) < 5e-3


def test_ba_noisy_observations_still_improve():
    win, X_gt, lms = _make_window(
        jax.random.PRNGKey(2), pose_noise=0.02, lm_noise=0.03, pixel_like_noise=1e-3
    )
    res = ba_solve(win, iters=8)
    assert float(res.cost) < float(res.cost0) * 0.1
    t_err = jnp.linalg.norm(res.X[:, :3, 3] - X_gt[:, :3, 3], axis=-1)
    assert float(jnp.max(t_err)) < 0.02


def test_ba_masked_landmarks_do_not_move():
    win, X_gt, lms = _make_window(jax.random.PRNGKey(3), pose_noise=0.01, lm_noise=0.02)
    w = win.weights.at[:, L // 2 :, :].set(0.0)          # mask half the slots
    win = win._replace(weights=w)
    res = ba_solve(win, iters=6)
    # Unobserved landmarks must not move (their updates are pure damping).
    moved = jnp.linalg.norm(res.landmarks[L // 2 :] - win.landmarks[L // 2 :], axis=-1)
    assert float(jnp.max(moved)) < 1e-6
    # Observed half still drives pose recovery.
    t_err = jnp.linalg.norm(res.X[:, :3, 3] - X_gt[:, :3, 3], axis=-1)
    assert float(jnp.max(t_err)) < 1e-3


def test_ba_gauge_anchor_fixed():
    win, X_gt, lms = _make_window(jax.random.PRNGKey(4), pose_noise=0.02, lm_noise=0.02)
    res = ba_solve(win, iters=6)
    assert float(jnp.max(jnp.abs(res.X[0] - win.X[0]))) < 1e-6


def test_solve6x6_spd_matches_linalg():
    from sosvo.backend.schur import inv6x6_spd, solve6x6_spd

    key = jax.random.PRNGKey(3)
    A = jax.random.normal(key, (12, 6, 6))
    H = A @ jnp.swapaxes(A, -1, -2) + 0.1 * jnp.eye(6)
    g = jax.random.normal(jax.random.PRNGKey(4), (12, 6))
    x_ref = jnp.linalg.solve(H, g[..., None])[..., 0]
    x = solve6x6_spd(H, g)
    assert float(jnp.max(jnp.abs(x - x_ref))) < 1e-4
    Hinv = inv6x6_spd(H)
    assert float(jnp.max(jnp.abs(Hinv @ H - jnp.eye(6)))) < 1e-3


def test_ba_window_with_origin_keyframe_and_empty_slots():
    """Regression (r3): a keyframe at the WORLD ORIGIN plus unused landmark
    slots (lm_pos = 0, weight 0) used to produce NaN normal equations.

    The empty slot sits exactly at the origin keyframe's top viewpoint, and
    d/dx |d| at d=0 is NaN; `lax.max`'s multiply-based JVP leaked it through
    the `d / max(|d|, eps)` normalize into (weight-zero!) Jacobian blocks,
    H_ll went NaN, and every LM step was silently rejected. Since every
    trajectory starts at the origin, ALL window BA was a no-op while
    keyframe 0 remained in the window."""
    win, X_gt, lms = _make_window(jax.random.PRNGKey(6), pose_noise=0.02,
                                  lm_noise=0.02)
    # Keyframe 0 exactly at the world origin (rig frame == world frame).
    X = win.X.at[0].set(jnp.eye(4, dtype=jnp.float32))
    # Append 8 empty landmark slots at the origin, zero-weighted everywhere.
    lms0 = jnp.concatenate([win.landmarks, jnp.zeros((8, 3), jnp.float32)])
    rays = jnp.concatenate([win.rays, jnp.zeros((W, 8, 2, 3), jnp.float32)], axis=1)
    weights = jnp.concatenate([win.weights, jnp.zeros((W, 8, 2), jnp.float32)], axis=1)
    win = win._replace(X=X, landmarks=lms0, rays=rays, weights=weights)

    res = ba_solve(win, iters=6)
    assert bool(jnp.isfinite(res.cost)), "BA cost is not finite"
    assert bool(jnp.all(jnp.isfinite(res.X))), "BA poses are not finite"
    assert bool(jnp.all(jnp.isfinite(res.landmarks))), "BA landmarks not finite"
    # The solve must actually make progress (the old behavior silently
    # rejected every step: cost == cost0, accepted all-False).
    assert bool(jnp.any(res.accepted)), "all LM steps rejected"
    assert float(res.cost) < 0.5 * float(res.cost0)
    # Huber path too (it reduced cost by adjusting only landmarks before).
    res_h = ba_solve(win, iters=6, huber_delta=0.005)
    assert bool(jnp.all(jnp.isfinite(res_h.X)))
    assert float(res_h.cost) < float(res_h.cost0)
