"""Plain float64 reference for the Schur reduction, and a BA window to feed it.

Shared by the unit tests (`tests/test_schur.py`) and the on-card smoke
(`chip_smoke.py`), which both hold `sosvo.backend.schur.reduce_camera_system`
to `schur_reference_f64` within `SCHUR_RTOL_S` on S and `SCHUR_RTOL_B` on
b_red.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Relative tolerances of the float32 reduction against float64, set from
# readings on an H100 and the CPU (PERF.md, PR 1 findings). At `highest`
# matmul precision S is within 4.3e-7 and b_red within 8.2e-7 at every
# (W, L) checked. With TF32 operands the H100 puts S off by 6.6e-6 to
# 1.9e-5, but leaves b_red as it was: its matrix-vector products do not run
# on the tensor cores. So the limit on S sits between the two readings and
# fails a reduction that lost `highest`; the one on b_red fails bfloat16
# operands (3.4e-4 at (8, 4096)) but cannot see TF32.
SCHUR_RTOL_S = 2e-6
SCHUR_RTOL_B = 1e-5


def schur_reference_f64(H_cc, H_cl, H_ll, b_c, b_l):
    """Dense (6W, 6W) Schur complement of the landmark blocks, in float64."""
    H_cc, H_cl, H_ll, b_c, b_l = (np.asarray(a, np.float64)
                                  for a in (H_cc, H_cl, H_ll, b_c, b_l))
    W, L = H_cl.shape[:2]
    B = H_cl.transpose(1, 0, 2, 3).reshape(L, 6 * W, 3)   # per-landmark coupling
    Y = B @ np.linalg.inv(H_ll)                           # (L, 6W, 3)
    S = np.zeros((6 * W, 6 * W))
    for w in range(W):
        S[6 * w:6 * w + 6, 6 * w:6 * w + 6] = H_cc[w]
    S -= np.einsum("lik,ljk->ij", Y, B)
    b = b_c.reshape(6 * W) - np.einsum("lik,lk->i", Y, b_l)
    return S, b


def ba_window(W: int, L: int, seed: int):
    """A noisy, perturbed W-keyframe window of L two-view landmarks."""
    from sosvo.backend.ba import BAWindow
    from sosvo.geom.lie import mat_inv, se3_exp, transform_points
    from sosvo.sensor.model import viewpoint
    from sosvo.sensor.rig import default_rig
    from sosvo.synth.scene import make_scene

    rig = default_rig()
    key = jax.random.PRNGKey(seed)
    scene = make_scene(key, n_frames=W, n_landmarks=max(L, 4096))
    lms = scene.landmarks[:L]
    X = jax.vmap(mat_inv)(scene.poses)
    vps = jnp.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    d = jax.vmap(lambda Xw: transform_points(Xw, lms))(X)[:, :, None] - vps
    k1, k2, k3 = jax.random.split(key, 3)
    rays = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    rays = rays + 1e-3 * jax.random.normal(k1, rays.shape)
    rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
    xi = (0.01 * jax.random.normal(k2, (W, 6))).at[0].set(0.0)
    return BAWindow(X=jnp.einsum("wij,wjk->wik", se3_exp(xi), X),
                    landmarks=lms + 0.02 * jax.random.normal(k3, lms.shape),
                    rays=rays, weights=jnp.ones((W, L, 2), jnp.float32),
                    viewpoints=vps)


def schur_rel_errors(W: int, L: int, seed: int, lam: float = 1e-3):
    """Max relative error of `reduce_camera_system` on S and b_red against
    `schur_reference_f64`, on a damped window of `ba_window(W, L, seed)`.
    Runs under the caller's default matmul precision."""
    from sosvo.backend.ba import build_blocks
    from sosvo.backend.schur import inv3x3, reduce_camera_system

    H_cc, H_cl, H_ll, b_c, b_l, _ = build_blocks(ba_window(W, L, seed))
    H_cc = H_cc + lam * jnp.eye(6)
    H_ll = H_ll + lam * jnp.eye(3)
    S, b_red = jax.jit(lambda *x: reduce_camera_system(
        x[0], x[1], inv3x3(x[2]), x[3], x[4]))(H_cc, H_cl, H_ll, b_c, b_l)
    S = np.asarray(S).transpose(0, 2, 1, 3).reshape(6 * W, 6 * W)
    S_ref, b_ref = schur_reference_f64(H_cc, H_cl, H_ll, b_c, b_l)
    es = float(np.max(np.abs(S - S_ref)) / np.max(np.abs(S_ref)))
    eb = float(np.max(np.abs(np.asarray(b_red).reshape(-1) - b_ref))
               / np.max(np.abs(b_ref)))
    return es, eb
