"""SO(3)/SE(3) Lie-group math, pure JAX.

JAX replacement for the reference's vendored rigid-transform utility
module (SURVEY.md C1: `omnistereo/transformations.py`, Gohlke's library).
Since the reference mount is empty (SURVEY.md SS0), parity targets are the
standard conventions of that library: right-handed frames, 4x4 homogeneous
matrices, quaternions in (w, x, y, z) order.

Design notes:
  * Everything is a pure function over jnp arrays; every function vmaps and
    jits. No data-dependent control flow -- small-angle branches are handled
    with `jnp.where` on numerically safe Taylor expansions.
  * f32-safe: thresholds are chosen for float32 (the working dtype). Tests verify
    round-trips at f32 tolerances (SURVEY.md SS4.1).
  * Representations: rotations as 3x3 matrices, rigid transforms as 4x4
    homogeneous matrices, tangent vectors as 6-vectors (omega, v) with the
    rotational part first.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: 3-vector -> skew-symmetric 3x3 matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of `hat`: skew-symmetric 3x3 -> 3-vector."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta2: jnp.ndarray):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3).

    Computed from theta^2 with Taylor fallbacks that are exact enough in f32
    for theta^2 < 1e-6, so the `where` never sees NaN gradients.
    """
    small = theta2 < 1e-6
    # Clamp the argument of the generic branch away from zero so its VALUE
    # and its GRADIENT are finite even where `small` selects the Taylor
    # branch (0 * NaN = NaN would otherwise leak through `where`'s vjp).
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2_safe * theta))
    return a, b, c


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so(3) -> SO(3) (Rodrigues), batched over leading dims."""
    theta2 = jnp.sum(w * w, axis=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map SO(3) -> so(3); uniformly robust (via quaternion).

    Extracts the quaternion with the branch-free Shepperd method (accurate for
    all angles including ~pi, unlike trace-only formulas in f32) and converts:
    w = 2 atan2(|q_vec|, q_w) * q_vec / |q_vec|.
    """
    q = mat_to_quat(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    vn = jnp.linalg.norm(qv, axis=-1)
    theta = 2.0 * jnp.arctan2(vn, qw)
    small = vn < 1e-6
    # Small-angle: theta/vn -> 2/qw (qw ~ 1); exact enough in f32.
    scale = jnp.where(small, 2.0 / jnp.maximum(qw, 0.5), theta / jnp.where(small, 1.0, vn))
    return scale[..., None] * qv


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map se(3) -> SE(3). xi = (omega[3], v[3]) -> 4x4."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    a, b, c = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map SE(3) -> se(3): 4x4 -> (omega, v)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    _, b, c = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2, with safe small-angle form.
    a, _, _ = _sinc_coeffs(theta2)
    small = theta2 < 1e-6
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    coef = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - a / (2.0 * b)) / theta2_safe)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


def rt_to_mat(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble 4x4 homogeneous transform from rotation + translation."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def mat_inv(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of a rigid 4x4 transform (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply 4x4 rigid transform(s) to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def rotate_dirs(T_or_R: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
    """Rotate (..., N, 3) direction vectors by the rotation part of T (4x4 or 3x3)."""
    R = T_or_R[..., :3, :3]
    return dirs @ jnp.swapaxes(R, -1, -2)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) -- matching the reference library's convention.
# ---------------------------------------------------------------------------

def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w,x,y,z) -> rotation matrix."""
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def mat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w,x,y,z), branch-free (Shepperd).

    Computes all four candidate quaternions and selects the one keyed by the
    largest denominator -- jit/vmap safe, no Python branching.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    # Candidate 0: trace-dominant.
    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], axis=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], axis=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], axis=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], axis=-1)

    scores = jnp.stack([tr, m00, m11, m22], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)
    q = jnp.take_along_axis(qs, idx[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    # Canonicalize sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0.0, -1.0, 1.0)


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize a near-rotation matrix via SVD (projection to SO(3))."""
    u, _, vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(u @ vt)
    d = jnp.ones(R.shape[:-2] + (3,), dtype=R.dtype).at[..., 2].set(det)
    return (u * d[..., None, :]) @ vt


def geodesic_angle(Ra: jnp.ndarray, Rb: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle (radians) between two rotation matrices."""
    Rrel = jnp.swapaxes(Ra, -1, -2) @ Rb
    trace = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    return jnp.arccos(jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0))
