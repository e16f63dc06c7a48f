"""Pure-JAX omnidirectional camera model (unified catadioptric / GUM).

JAX replacement for the reference's sensor-model layer (SURVEY.md C2/C3:
`omnistereo/camera_models.py`, the largest module of the reference). The
reference mount is empty (SURVEY.md SS0), so the model implemented here is the
published one underlying that code: the unified (sphere) model for a central
catadioptric camera -- a hyperbolic mirror whose focus coincides with the
pinhole's effective viewpoint, parameterised by the mirror parameter `xi`
(Geyer-Daniilidis / Mei; the papers' GUM reduces to this for a calibrated
hyperbolic mirror). BASELINE.json:5 mandates "mirror + pinhole lifting to unit
sphere rays ... pure JAX functions so the whole frontend+backend JITs
end-to-end" -- this module is that contract.

Projection (view frame, viewpoint at origin, z up the mirror axis):
    p_m = R_mis^T X                     (optional mirror-axis misalignment)
    s   = p_m / |p_m|                   (lift to unit sphere)
    m   = (s_x, s_y) / (s_z + xi)       (perspective from sphere-center + xi)
    m_d = distort(m)                    (radial k1,k2 + tangential p1,p2, on
                                         the normalized plane -- Mei's model)
    u   = fx * m_d_x + cx ;  v = fy * m_d_y + cy

Unprojection (exact inverse for zero distortion; fixed-point undistort
otherwise -- UNDISTORT_ITERS unrolled iterations, fully differentiable):
    m_d = ((u-cx)/fx, (v-cy)/fy)
    m   = undistort(m_d)                (m <- (m_d - tangential(m))/radial(m))
    eta = (xi + sqrt(1 + (1 - xi^2) r2)) / (r2 + 1)
    ray = R_mis (eta * m_x, eta * m_y, eta - xi)    (unit norm by construction)

The distortion/misalignment terms complete the published GUM (the unified
model plus lens distortion plus camera-mirror axis misalignment) that the
reference's `camera_models.py` carries (SURVEY.md C3; COMPAT.md #1): all
terms default to zero, in which case both directions reduce to the clean
closed forms above bit-for-bit.

All functions are differentiable (BA Jacobians flow through `project`),
shape-polymorphic over leading batch dims, and f32-safe.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

UNDISTORT_ITERS = 8  # fixed-point iterations; exact when distortion is zero


class ViewParams(NamedTuple):
    """Calibrated parameters of one catadioptric view (top or bottom mirror).

    A pytree of scalars/small arrays -- safe to close over or pass through jit.

    Attributes:
      xi: mirror parameter of the unified model (0 = pinhole, ->1 parabola).
      fx, fy, cx, cy: pinhole intrinsics of the (mirror-composed) projection.
      min_elevation, max_elevation: valid elevation band (radians) of this
        view; defines the annular valid region in the raw image.
      z_offset: viewpoint height on the common vertical axis, in the rig
        frame (top view usually 0, bottom view -baseline).
      k1, k2: radial distortion coefficients on the normalized plane.
      p1, p2: tangential distortion coefficients.
      mis_rx, mis_ry: mirror-axis misalignment -- a small rotation (radians,
        about the view frame's x and y axes) between the rig's nominal
        vertical axis and this mirror's actual axis. The z component is
        unobservable (pure azimuth shift) and therefore not modeled.
    """

    xi: jnp.ndarray
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    min_elevation: jnp.ndarray
    max_elevation: jnp.ndarray
    z_offset: jnp.ndarray
    k1: jnp.ndarray = jnp.float32(0.0)
    k2: jnp.ndarray = jnp.float32(0.0)
    p1: jnp.ndarray = jnp.float32(0.0)
    p2: jnp.ndarray = jnp.float32(0.0)
    mis_rx: jnp.ndarray = jnp.float32(0.0)
    mis_ry: jnp.ndarray = jnp.float32(0.0)

    @staticmethod
    def create(xi, fx, fy, cx, cy, min_elevation, max_elevation, z_offset=0.0,
               k1=0.0, k2=0.0, p1=0.0, p2=0.0, mis_rx=0.0, mis_ry=0.0):
        f = lambda x: jnp.asarray(x, dtype=jnp.float32)
        return ViewParams(f(xi), f(fx), f(fy), f(cx), f(cy), f(min_elevation),
                          f(max_elevation), f(z_offset), f(k1), f(k2), f(p1),
                          f(p2), f(mis_rx), f(mis_ry))


def viewpoint(view: ViewParams) -> jnp.ndarray:
    """The view's effective viewpoint (single effective focus) in rig frame."""
    z = jnp.asarray(view.z_offset)
    zero = jnp.zeros_like(z)
    return jnp.stack([zero, zero, z], axis=-1)


def _mis_rotation(view: ViewParams) -> jnp.ndarray:
    """(3, 3) rotation taking mirror-frame vectors to the view frame.

    Rodrigues on the axis (mis_rx, mis_ry, 0); exact for zero angle (the
    sinc-style Taylor guards keep it f32-safe near zero).
    """
    rx, ry = view.mis_rx, view.mis_ry
    th2 = rx * rx + ry * ry
    th = jnp.sqrt(th2)
    small = th < 1e-5
    # sin(th)/th and (1-cos(th))/th^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / jnp.where(small, 1.0, th))
    b = jnp.where(small, 0.5 - th2 / 24.0,
                  (1.0 - jnp.cos(th)) / jnp.where(small, 1.0, th2))
    zero = jnp.zeros_like(rx)
    K = jnp.stack([
        jnp.stack([zero, zero, ry], axis=-1),
        jnp.stack([zero, zero, -rx], axis=-1),
        jnp.stack([-ry, rx, zero], axis=-1),
    ], axis=-2)
    eye = jnp.eye(3, dtype=K.dtype)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _distort(view: ViewParams, mx: jnp.ndarray, my: jnp.ndarray):
    """Radial (k1, k2) + tangential (p1, p2) distortion on the normalized plane."""
    r2 = mx * mx + my * my
    rad = 1.0 + r2 * (view.k1 + r2 * view.k2)
    dx = 2.0 * view.p1 * mx * my + view.p2 * (r2 + 2.0 * mx * mx)
    dy = view.p1 * (r2 + 2.0 * my * my) + 2.0 * view.p2 * mx * my
    return rad * mx + dx, rad * my + dy


def _undistort(view: ViewParams, mdx: jnp.ndarray, mdy: jnp.ndarray):
    """Fixed-point inverse of `_distort` (UNDISTORT_ITERS unrolled steps).

    Identity when all coefficients are zero (the default), so the closed-form
    exact-inverse property of the clean unified model is preserved exactly.
    """
    mx, my = mdx, mdy
    for _ in range(UNDISTORT_ITERS):
        r2 = mx * mx + my * my
        rad = 1.0 + r2 * (view.k1 + r2 * view.k2)
        dx = 2.0 * view.p1 * mx * my + view.p2 * (r2 + 2.0 * mx * mx)
        dy = view.p1 * (r2 + 2.0 * my * my) + 2.0 * view.p2 * mx * my
        mx = (mdx - dx) / rad
        my = (mdy - dy) / rad
    return mx, my


def project(view: ViewParams, pts_view: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Project 3D points (view frame, viewpoint at origin) to pixels.

    Args:
      view: calibrated view parameters.
      pts_view: (..., 3) points in the view frame.

    Returns:
      uv: (..., 2) pixel coordinates (u = column-ish x, v = row-ish y).
      valid: (...,) bool -- point inside the view's elevation band and in
        front of the model's projection singularity (s_z + xi > eps).
    """
    R_mis = _mis_rotation(view)
    pts_m = pts_view @ R_mis            # R_mis^T @ p, batched over rows
    norm = jnp.linalg.norm(pts_m, axis=-1, keepdims=True)
    s = pts_m / jnp.maximum(norm, 1e-9)
    denom = s[..., 2] + view.xi
    safe = denom > 1e-6
    denom_safe = jnp.where(safe, denom, 1.0)
    mx = s[..., 0] / denom_safe
    my = s[..., 1] / denom_safe
    mx, my = _distort(view, mx, my)
    u = view.fx * mx + view.cx
    v = view.fy * my + view.cy
    elevation = jnp.arcsin(jnp.clip(s[..., 2], -1.0, 1.0))
    valid = (
        safe
        & (elevation >= view.min_elevation)
        & (elevation <= view.max_elevation)
        & (norm[..., 0] > 1e-6)
    )
    return jnp.stack([u, v], axis=-1), valid


def lift(view: ViewParams, uv: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Lift pixels to unit-sphere rays in the view frame (closed-form inverse).

    Args:
      view: calibrated view parameters.
      uv: (..., 2) pixel coordinates.

    Returns:
      ray: (..., 3) unit direction leaving the viewpoint.
      valid: (...,) bool -- ray's elevation inside the view band.
    """
    mx = (uv[..., 0] - view.cx) / view.fx
    my = (uv[..., 1] - view.cy) / view.fy
    mx, my = _undistort(view, mx, my)
    r2 = mx * mx + my * my
    disc = 1.0 + (1.0 - view.xi * view.xi) * r2
    eta = (view.xi + jnp.sqrt(jnp.maximum(disc, 0.0))) / (r2 + 1.0)
    ray = jnp.stack([eta * mx, eta * my, eta - view.xi], axis=-1)
    ray = ray / jnp.maximum(jnp.linalg.norm(ray, axis=-1, keepdims=True), 1e-9)
    # Elevation gating happens in the MIRROR frame (where the annulus is
    # defined); the returned ray is rotated back into the view frame.
    elevation = jnp.arcsin(jnp.clip(ray[..., 2], -1.0, 1.0))
    valid = (elevation >= view.min_elevation) & (elevation <= view.max_elevation) & (disc > 0.0)
    ray = ray @ _mis_rotation(view).T   # R_mis @ ray, batched over rows
    return ray, valid


def radius_of_elevation(view: ViewParams, elevation: jnp.ndarray) -> jnp.ndarray:
    """Image radius (pixels, isotropic f = fx) of a ray at given elevation.

    Used to derive the annular valid-region bounds of the view in the raw
    image (SURVEY.md C3 "valid-region masks (annuli)").
    """
    sz = jnp.sin(elevation)
    c = jnp.cos(elevation)
    return view.fx * c / (sz + view.xi)


def annulus_bounds(view: ViewParams) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(r_inner, r_outer) pixel radii of this view's valid annulus.

    Radius decreases with elevation (higher elevation -> closer to center),
    so r_inner corresponds to max_elevation and r_outer to min_elevation.
    """
    r_hi = radius_of_elevation(view, view.max_elevation)
    r_lo = radius_of_elevation(view, view.min_elevation)
    return jnp.minimum(r_hi, r_lo), jnp.maximum(r_hi, r_lo)


def annulus_mask(view: ViewParams, height: int, width: int) -> jnp.ndarray:
    """Boolean (H, W) mask of the view's valid annulus in the raw image."""
    r_in, r_out = annulus_bounds(view)
    vv = jnp.arange(height, dtype=jnp.float32)[:, None]
    uu = jnp.arange(width, dtype=jnp.float32)[None, :]
    r = jnp.sqrt((uu - view.cx) ** 2 + (vv - view.cy) ** 2)
    return (r >= r_in) & (r <= r_out)
