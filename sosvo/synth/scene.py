"""Synthetic omnistereo world with exact ground truth.

JAX replacement for the reference's synthetic-data path (SURVEY.md C17:
POV-Ray-rendered sequences with exact ground truth [P1/K]). Per SURVEY.md SS4,
the one genuinely reusable testing idea in the reference is validating against
synthetic scenes with exact ground truth; this module is the backbone of that
strategy. Instead of ray-traced images it can emit *feature observations
directly* (project known 3D landmarks + optional noise), which is exactly
benchmark config c1 (BASELINE.json:7: "Synthetic 10-frame omnistereo sequence,
~500 features/frame"); the full image path is in `sosvo/synth/render.py`.

Everything here is jit/vmap-friendly with fixed shapes: each frame carries
exactly `max_features` observation slots plus a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.geom.lie import mat_inv, rt_to_mat, so3_exp, transform_points
from sosvo.sensor.model import lift, project, viewpoint
from sosvo.sensor.rig import OmnistereoRig

DESC_WORDS = 8  # 256-bit descriptors packed as 8 x uint32 (SURVEY.md C6/C7).


class FrameObservations(NamedTuple):
    """Fixed-size per-frame feature observations (possibly batched over frames).

    Slots beyond the number of visible landmarks are invalid (mask False) and
    hold zeros. `lm_id` is the ground-truth landmark index, used only by
    oracle tests -- the pipeline itself never reads it.
    """

    uv_top: jnp.ndarray      # (..., K, 2) pixel coords in the raw image, top view
    uv_bottom: jnp.ndarray   # (..., K, 2) bottom view
    ray_top: jnp.ndarray     # (..., K, 3) unit rays (rig frame) from top viewpoint
    ray_bottom: jnp.ndarray  # (..., K, 3) unit rays from bottom viewpoint
    desc_top: jnp.ndarray    # (..., K, DESC_WORDS) uint32 packed descriptors
    desc_bottom: jnp.ndarray
    valid_top: jnp.ndarray    # (..., K) bool -- top-view feature slots in use
    valid_bottom: jnp.ndarray  # (..., K) bool (== valid_top in observation mode,
                               # independent detections in image mode)
    lm_id: jnp.ndarray       # (..., K) int32 ground-truth landmark index

    @property
    def valid(self) -> jnp.ndarray:
        """Slots valid in both views (observation-mode convenience)."""
        return self.valid_top & self.valid_bottom


class Scene(NamedTuple):
    landmarks: jnp.ndarray     # (L, 3) world-frame 3D points
    lm_desc: jnp.ndarray       # (L, DESC_WORDS) uint32 canonical descriptor per landmark
    poses: jnp.ndarray         # (F, 4, 4) ground-truth world-from-rig poses


def make_landmarks(key: jax.Array, n: int, r_min: float = 1.5, r_max: float = 6.0,
                   z_min: float = -1.5, z_max: float = 1.0) -> jnp.ndarray:
    """Random landmarks in a cylindrical shell around the trajectory region."""
    k1, k2, k3 = jax.random.split(key, 3)
    theta = jax.random.uniform(k1, (n,), minval=-jnp.pi, maxval=jnp.pi)
    r = jnp.sqrt(jax.random.uniform(k2, (n,), minval=r_min**2, maxval=r_max**2))
    z = jax.random.uniform(k3, (n,), minval=z_min, maxval=z_max)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), z], axis=-1).astype(jnp.float32)


def make_trajectory(n_frames: int, radius: float = 0.8, height_amp: float = 0.15,
                    yaw_per_frame: float = 0.03, times=None) -> jnp.ndarray:
    """Smooth closed-loop-ish trajectory: circular arc + gentle bobbing + yaw.

    Returns (F, 4, 4) world-from-rig poses. Deterministic (no RNG) so tests
    can rely on exact values. `times` (F,) warps the curve parameter --
    non-uniform spacing yields a variable-SPEED trajectory along the same
    path (used by the adaptive-keyframing tests).
    """
    t = (jnp.arange(n_frames, dtype=jnp.float32) if times is None
         else jnp.asarray(times, jnp.float32))
    ang = t * yaw_per_frame * 2.0
    pos = jnp.stack(
        [radius * jnp.cos(ang) - radius, radius * jnp.sin(ang), height_amp * jnp.sin(t * 0.11)],
        axis=-1,
    )
    yaw = t * yaw_per_frame
    pitch = 0.05 * jnp.sin(t * 0.07)
    w = jnp.stack([jnp.zeros_like(yaw), pitch, yaw], axis=-1)
    R = so3_exp(w)
    return rt_to_mat(R, pos)


def landmark_descriptors(key: jax.Array, n_landmarks: int) -> jnp.ndarray:
    """One canonical random 256-bit descriptor per landmark (packed uint32)."""
    bits = jax.random.bits(key, (n_landmarks, DESC_WORDS), dtype=jnp.uint32)
    return bits


def corrupt_descriptors(key: jax.Array, desc: jnp.ndarray, flip_prob: float) -> jnp.ndarray:
    """Flip each descriptor bit independently with probability flip_prob."""
    if flip_prob <= 0.0:
        return desc
    nbits = 32
    flips = jnp.zeros_like(desc)
    keys = jax.random.split(key, nbits)
    for b in range(nbits):
        mask = jax.random.bernoulli(keys[b], flip_prob, desc.shape)
        flips = flips | (mask.astype(jnp.uint32) << jnp.uint32(b))
    return desc ^ flips


def make_scene(key: jax.Array, n_frames: int, n_landmarks: int = 4096) -> Scene:
    k_lm, k_desc = jax.random.split(key)
    return Scene(
        landmarks=make_landmarks(k_lm, n_landmarks),
        lm_desc=landmark_descriptors(k_desc, n_landmarks),
        poses=make_trajectory(n_frames),
    )


def observe_frame(
    rig: OmnistereoRig,
    scene: Scene,
    frame_idx: jnp.ndarray,
    max_features: int,
    key: jax.Array,
    pixel_noise: float = 0.0,
    desc_flip_prob: float = 0.0,
) -> FrameObservations:
    """Exact (optionally noisy) observations of the scene from one pose.

    Projects all landmarks through both views, keeps the `max_features`
    stereo-visible ones (fixed-size top-k with validity mask), adds optional
    pixel noise, and re-lifts the noisy pixels to unit rays -- so the ray
    observations are exactly what the image frontend would produce, minus
    detection error.
    """
    T_wr = scene.poses[frame_idx]
    pts_rig = transform_points(mat_inv(T_wr), scene.landmarks)

    pts_top = pts_rig - viewpoint(rig.top)
    pts_bot = pts_rig - viewpoint(rig.bottom)
    uv_t, ok_t = project(rig.top, pts_top)
    uv_b, ok_b = project(rig.bottom, pts_bot)
    visible = ok_t & ok_b

    # Fixed-size selection among visible landmarks. Ties are broken by a
    # per-landmark priority derived from the landmark's canonical descriptor,
    # NOT per-frame randomness: a real detector consistently re-fires on the
    # same strong corners, so consecutive frames must observe a largely
    # overlapping landmark set (that overlap is what temporal matching and
    # frame-to-frame VO live on).
    k_nt, k_nb, k_dt, k_db = jax.random.split(key, 4)
    priority = (scene.lm_desc[:, 0] & jnp.uint32(0xFFFF)).astype(jnp.float32) / jnp.float32(1 << 17)
    score = visible.astype(jnp.float32) + priority
    _, idx = jax.lax.top_k(score, max_features)
    valid = visible[idx]

    uv_t = uv_t[idx] + pixel_noise * jax.random.normal(k_nt, (max_features, 2))
    uv_b = uv_b[idx] + pixel_noise * jax.random.normal(k_nb, (max_features, 2))
    ray_t, _ = lift(rig.top, uv_t)
    ray_b, _ = lift(rig.bottom, uv_b)

    desc = scene.lm_desc[idx]
    desc_t = corrupt_descriptors(k_dt, desc, desc_flip_prob)
    desc_b = corrupt_descriptors(k_db, desc, desc_flip_prob)

    z = jnp.float32(0)
    return FrameObservations(
        uv_top=jnp.where(valid[:, None], uv_t, z),
        uv_bottom=jnp.where(valid[:, None], uv_b, z),
        ray_top=jnp.where(valid[:, None], ray_t, z),
        ray_bottom=jnp.where(valid[:, None], ray_b, z),
        desc_top=jnp.where(valid[:, None], desc_t, jnp.uint32(0)),
        desc_bottom=jnp.where(valid[:, None], desc_b, jnp.uint32(0)),
        valid_top=valid,
        valid_bottom=valid,
        lm_id=jnp.where(valid, idx, -1).astype(jnp.int32),
    )


def observe_sequence(
    rig: OmnistereoRig,
    scene: Scene,
    max_features: int,
    key: jax.Array,
    pixel_noise: float = 0.0,
    desc_flip_prob: float = 0.0,
) -> FrameObservations:
    """Vmapped observations for every frame: each field gains a leading F dim."""
    n_frames = scene.poses.shape[0]
    keys = jax.random.split(key, n_frames)
    return jax.vmap(
        lambda i, k: observe_frame(rig, scene, i, max_features, k, pixel_noise, desc_flip_prob)
    )(jnp.arange(n_frames), keys)


def triangulation_ground_truth(rig: OmnistereoRig, scene: Scene, frame_idx: int) -> jnp.ndarray:
    """Rig-frame landmark positions at a frame (for triangulation tests)."""
    return transform_points(mat_inv(scene.poses[frame_idx]), scene.landmarks)
