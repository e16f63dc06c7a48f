"""Omnistereo triangulation: midpoint of the common perpendicular, batched.

JAX replacement for the reference's stereo triangulation (SURVEY.md C8:
top-ray x bottom-ray midpoint triangulation with validity gating [P1/P2]).
Closed-form, fully vmapped -- no per-point loop. The two viewpoints sit on the
rig's vertical axis (top at origin, bottom at -baseline z), so the vertical
baseline gives range from the elevation disparity at every azimuth [P2].
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class TriangulationResult(NamedTuple):
    points: jnp.ndarray     # (..., 3) rig-frame 3D points
    depth_top: jnp.ndarray  # (...,) range along the top ray
    angle: jnp.ndarray      # (...,) ray-ray angle (radians) -- conditioning proxy
    gap: jnp.ndarray        # (...,) distance between the two closest ray points
    valid: jnp.ndarray      # (...,) bool: positive depths + gating thresholds


def midpoint_triangulate(
    ray_top: jnp.ndarray,
    ray_bottom: jnp.ndarray,
    c_top: jnp.ndarray,
    c_bottom: jnp.ndarray,
    min_angle: float = 0.004,
    max_range: float = 50.0,
    max_gap: float = 0.08,
) -> TriangulationResult:
    """Midpoint of the common perpendicular between two (skew) rays.

    Solves min_{s,t} | (c1 + s r1) - (c2 + t r2) |^2 in closed form:
        s = (b e - c d) / (1 - b^2),  t = (e - b d) / ... with
        b = r1.r2, d = r1.(c1-c2), e = r2.(c1-c2)   (unit rays).

    Args:
      ray_top, ray_bottom: (..., 3) unit rays in the rig frame.
      c_top, c_bottom: (3,) or broadcastable viewpoints in the rig frame.
      min_angle: minimum ray-ray angle (rad) -- rejects near-parallel rays
        whose depth is unbounded (far-field gating, SURVEY.md C8).
      max_range: maximum accepted range along the top ray (m).
      max_gap: maximum accepted closest-approach distance between rays (m) --
        rejects bad matches whose rays don't nearly intersect.

    Returns:
      TriangulationResult with points at the perpendicular midpoint.
    """
    r1, r2 = ray_top, ray_bottom
    dc = c_top - c_bottom
    b = jnp.sum(r1 * r2, axis=-1)
    d = jnp.sum(r1 * dc, axis=-1)
    e = jnp.sum(r2 * dc, axis=-1)
    denom = 1.0 - b * b
    denom_safe = jnp.maximum(denom, 1e-9)
    s = (b * e - d) / denom_safe
    t = (e - b * d) / denom_safe
    p1 = c_top + s[..., None] * r1
    p2 = c_bottom + t[..., None] * r2
    mid = 0.5 * (p1 + p2)
    gap = jnp.linalg.norm(p1 - p2, axis=-1)
    angle = jnp.arccos(jnp.clip(b, -1.0, 1.0))
    valid = (
        (s > 1e-3)
        & (t > 1e-3)
        & (s < max_range)
        & (angle > min_angle)
        & (gap < max_gap)
        & (denom > 1e-9)
    )
    return TriangulationResult(points=mid, depth_top=s, angle=angle, gap=gap, valid=valid)
