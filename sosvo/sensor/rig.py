"""Omnistereo rig: the top+bottom view pair on a common vertical axis.

JAX replacement for the reference's omnistereo-pair class (SURVEY.md
C4: a class in `omnistereo/camera_models.py` binding the two GUM view models
with their common-axis geometry and baseline). Implemented as a NamedTuple
pytree so a rig can be closed over by jit, vmapped over (e.g. per-sequence
rigs in batched replay, BASELINE.json:10), and serialized trivially.

Rig frame convention: origin at the TOP view's effective viewpoint, z up the
shared mirror axis. The bottom view's viewpoint sits at z = -baseline.
Azimuth is atan2(y, x); the two views are azimuth-aligned by construction
(coaxial mirrors), which is what makes epipolar curves map to panorama
*columns* (SURVEY.md SS0.1, [P1]).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sosvo.sensor.model import ViewParams, lift, project, viewpoint


class OmnistereoRig(NamedTuple):
    """Calibrated omnistereo sensor: two coaxial catadioptric views.

    Attributes:
      top: ViewParams of the top-mirror view (viewpoint at rig origin).
      bottom: ViewParams of the bottom-mirror view (viewpoint at -baseline z).
      baseline: vertical distance between the two effective viewpoints (m).
      image_height, image_width: raw omnidirectional image size (static ints
        kept as python ints so shapes stay static under jit).
    """

    top: ViewParams
    bottom: ViewParams
    baseline: jnp.ndarray
    image_height: int
    image_width: int


def default_rig(image_size: int = 768, baseline: float = 0.12) -> OmnistereoRig:
    """A physically plausible MAV-scale rig (SURVEY.md [P2]: ~12 cm baseline).

    Parameters are chosen so the two annuli are disjoint in the raw image:
    the top view occupies the outer annulus and the bottom view the inner one,
    as in the real folded-catadioptric sensor. The image-radius budget is
    split to give the bottom (inner) view as much angular resolution as the
    disjointness constraint allows -- vertical-baseline depth error grows as
    depth^2 x angular-resolution / baseline, so bottom-view resolution is the
    sensor's depth-accuracy bottleneck (the design tradeoff [P2] optimizes).
    """
    c = image_size / 2.0 - 0.5
    s = image_size / 768.0
    top = ViewParams.create(
        xi=0.96,
        fx=150.0 * s,
        fy=150.0 * s,
        cx=c,
        cy=c,
        min_elevation=jnp.deg2rad(-38.0),
        max_elevation=jnp.deg2rad(14.0),
        z_offset=0.0,
    )
    bottom = ViewParams.create(
        xi=0.92,
        fx=48.0 * s,
        fy=48.0 * s,
        cx=c,
        cy=c,
        min_elevation=jnp.deg2rad(-35.0),
        max_elevation=jnp.deg2rad(12.0),
        z_offset=-baseline,
    )
    return OmnistereoRig(
        top=top,
        bottom=bottom,
        baseline=jnp.asarray(baseline, jnp.float32),
        image_height=image_size,
        image_width=image_size,
    )


def scale_rig(rig: OmnistereoRig, factor: float) -> OmnistereoRig:
    """The SAME physical sensor expressed at a different image resolution.

    Calibration captures are typically shot at higher resolution than the
    runtime replay (e.g. 1536 vs 768; SURVEY.md C16 -> C3 handoff): pinhole
    intrinsics scale linearly with image size under the half-pixel-center
    convention (u' = (u + 0.5) * factor - 0.5), while xi, the distortion
    terms (normalized-plane), misalignment, elevations, and the metric
    baseline are resolution-invariant.
    """

    def scale_view(v: ViewParams) -> ViewParams:
        f = jnp.float32(factor)
        return v._replace(
            fx=v.fx * f, fy=v.fy * f,
            cx=(v.cx + 0.5) * f - 0.5, cy=(v.cy + 0.5) * f - 0.5,
        )

    return rig._replace(
        top=scale_view(rig.top), bottom=scale_view(rig.bottom),
        image_height=int(round(rig.image_height * factor)),
        image_width=int(round(rig.image_width * factor)),
    )


def project_rig(rig: OmnistereoRig, pts_rig: jnp.ndarray):
    """Project rig-frame points through both views.

    Returns ((uv_top, valid_top), (uv_bottom, valid_bottom)).
    """
    pts_top = pts_rig - viewpoint(rig.top)
    pts_bot = pts_rig - viewpoint(rig.bottom)
    return project(rig.top, pts_top), project(rig.bottom, pts_bot)


def lift_rig(rig: OmnistereoRig, uv: jnp.ndarray, use_top: bool):
    """Lift pixels through one view; rays are in the rig frame (shared axes)."""
    view = rig.top if use_top else rig.bottom
    return lift(view, uv)


def stereo_overlap_band(rig: OmnistereoRig) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Elevation band (radians) visible to BOTH views at infinity.

    The common field of view that supports stereo triangulation (SURVEY.md C4
    "stereo ROI overlap").
    """
    lo = jnp.maximum(rig.top.min_elevation, rig.bottom.min_elevation)
    hi = jnp.minimum(rig.top.max_elevation, rig.bottom.max_elevation)
    return lo, hi
