"""VO state pytrees: per-frame tracking state and per-frame outputs.

The reference keeps VO state in driver-script locals (SURVEY.md C15); here it
is an explicit fixed-shape pytree so the whole per-frame step jits, scans over
frames, vmaps over sequences (BASELINE.json:10), and checkpoints as .npz
files (`sosvo/utils/checkpoint.py`, SURVEY.md SS5.4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.frontend.descriptor import SIFT_DIM
from sosvo.synth.scene import DESC_WORDS


def desc_zeros(k: int, descriptor: str = "brief") -> jnp.ndarray:
    """Empty descriptor buffer matching the configured frontend descriptor:
    packed-uint32 BRIEF words or float32 SIFT vectors (SURVEY.md C6)."""
    if descriptor == "sift":
        return jnp.zeros((k, SIFT_DIM), jnp.float32)
    return jnp.zeros((k, DESC_WORDS), jnp.uint32)


class TrackState(NamedTuple):
    """Carry of the frame-to-frame VO loop (fixed shapes, K feature slots)."""

    T_world: jnp.ndarray      # (4, 4) world-from-rig pose of the current frame
    prev_points: jnp.ndarray  # (K, 3) triangulated points in the previous rig frame
    prev_desc: jnp.ndarray    # (K, DESC_WORDS) uint32 descriptors of those points
    prev_rays: jnp.ndarray    # (K, 3) top-view unit rays of those points
    prev_azimuth: jnp.ndarray  # (K,) azimuth (rad) of those rays
    prev_valid: jnp.ndarray   # (K,) bool
    frame_idx: jnp.ndarray    # () int32
    key: jax.Array            # PRNG key


class StepOutput(NamedTuple):
    """Per-frame diagnostics + pose (the structured log row, SURVEY.md SS5.5)."""

    T_world: jnp.ndarray        # (4, 4)
    n_stereo: jnp.ndarray       # () int32 stereo matches surviving triangulation
    n_temporal: jnp.ndarray     # () int32 temporal matches
    n_inliers: jnp.ndarray      # () int32 RANSAC inliers
    pose_ok: jnp.ndarray        # () bool: pose accepted (else constant-velocity hold)
    ess_angle_err: jnp.ndarray  # () f32 rotation angle between rigid & essential estimates


def init_track_state(max_features: int, key: jax.Array, T0: jnp.ndarray | None = None,
                     descriptor: str = "brief") -> TrackState:
    k = max_features
    return TrackState(
        T_world=jnp.eye(4, dtype=jnp.float32) if T0 is None else T0,
        prev_points=jnp.zeros((k, 3), jnp.float32),
        prev_desc=desc_zeros(k, descriptor),
        prev_rays=jnp.zeros((k, 3), jnp.float32),
        prev_azimuth=jnp.zeros((k,), jnp.float32),
        prev_valid=jnp.zeros((k,), bool),
        frame_idx=jnp.asarray(0, jnp.int32),
        key=key,
    )
