"""Sliding keyframe window + landmark map, fixed shapes, ring-buffered.

The reference's VO is frame-to-frame with no persistent map [P1]; windowed BA
over keyframes is mandated by the north star (BASELINE.json:5/8 "keyframes and
map blocks ... windowed bundle adjustment"). This module is the state machine
that feeds `sosvo/backend/ba.py`:

  - W keyframe slots in a ring buffer (kf ring index `head`);
  - L landmark slots (world position + descriptor + staleness), evicted
    oldest-first when full;
  - a DENSE (W, L, 2) observation grid (rays + weights) -- the exact
    `BAWindow` layout, so keyframe insertion IS window construction and the
    landmark axis is ready for "model"-sharding (BASELINE.json:11).

Everything is masked fixed-shape updates (scatter via .at[]), so the whole
keyframe step jits and runs under `lax.cond` inside the replay scan.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.backend.ba import BAWindow, ba_solve
from sosvo.frontend.match import match
from sosvo.geom.lie import mat_inv, transform_points
from sosvo.sensor.model import viewpoint
from sosvo.sensor.rig import OmnistereoRig
from sosvo.synth.scene import DESC_WORDS  # noqa: F401  (re-exported layout constant)
from sosvo.vo.state import desc_zeros

STALE_BIG = 1e6


class MapState(NamedTuple):
    """Keyframe window + landmark map (a pytree of fixed-shape arrays)."""

    kf_X: jnp.ndarray        # (W, 4, 4) rig-from-world per keyframe slot
    kf_valid: jnp.ndarray    # (W,) bool
    kf_frame: jnp.ndarray    # (W,) int32 frame index of the keyframe
    head: jnp.ndarray        # () int32 most recent keyframe slot
    n_kf: jnp.ndarray        # () int32 number of valid keyframes (<= W)
    lm_pos: jnp.ndarray      # (L, 3) world-frame landmark positions
    lm_desc: jnp.ndarray     # (L, DESC_WORDS) uint32
    lm_valid: jnp.ndarray    # (L,) bool
    lm_last_seen: jnp.ndarray  # (L,) int32 keyframe counter of last observation
    obs_rays: jnp.ndarray    # (W, L, 2, 3) observed unit bearings per view
    obs_w: jnp.ndarray       # (W, L, 2) observation weights (0 = none)


def init_map_state(window: int, max_landmarks: int, descriptor: str = "brief") -> MapState:
    W, L = window, max_landmarks
    return MapState(
        kf_X=jnp.tile(jnp.eye(4, dtype=jnp.float32), (W, 1, 1)),
        kf_valid=jnp.zeros((W,), bool),
        kf_frame=jnp.full((W,), -1, jnp.int32),
        head=jnp.asarray(-1, jnp.int32),
        n_kf=jnp.asarray(0, jnp.int32),
        lm_pos=jnp.zeros((L, 3), jnp.float32),
        lm_desc=desc_zeros(L, descriptor),
        lm_valid=jnp.zeros((L,), bool),
        lm_last_seen=jnp.full((L,), -(10**6), jnp.int32),
        obs_rays=jnp.zeros((W, L, 2, 3), jnp.float32),
        obs_w=jnp.zeros((W, L, 2), jnp.float32),
    )


class KeyframeFeatures(NamedTuple):
    """Per-frame stereo-triangulated features handed to the map manager."""

    pts_rig: jnp.ndarray   # (K, 3) triangulated points, current rig frame
    desc: jnp.ndarray      # (K, DESC_WORDS) uint32
    ray_top: jnp.ndarray   # (K, 3)
    ray_bottom: jnp.ndarray  # (K, 3) stereo-matched bottom-view rays
    valid: jnp.ndarray     # (K,)


def insert_keyframe(
    m: MapState,
    T_world: jnp.ndarray,
    feats: KeyframeFeatures,
    frame_idx: jnp.ndarray,
    max_new: int,
    match_max_distance: float = 80.0,
    match_ratio: float = 0.9,
    metric: str = "hamming",
) -> MapState:
    """Add a keyframe: associate map landmarks, insert new ones, record obs."""
    W = m.kf_X.shape[0]
    L = m.lm_pos.shape[0]
    new_head = jnp.mod(m.head + 1, W)
    kf_counter = m.n_kf  # monotone per-keyframe counter proxy

    # --- clear the reused keyframe slot ---
    obs_w = m.obs_w.at[new_head].set(0.0)
    obs_rays = m.obs_rays.at[new_head].set(0.0)

    X_new = mat_inv(T_world)
    kf_X = m.kf_X.at[new_head].set(X_new)
    kf_valid = m.kf_valid.at[new_head].set(True)
    kf_frame = m.kf_frame.at[new_head].set(frame_idx.astype(jnp.int32))

    # --- data association: map landmarks -> current features ---
    # (Hamming for binary descriptors, L2 for SIFT -- callers pass
    # `frontend.match.metric_params(cfg.frontend)`.)
    mm = match(m.lm_desc, feats.desc, m.lm_valid, feats.valid,
               max_distance=match_max_distance, ratio=match_ratio,
               metric=metric)
    assoc = mm.valid                      # (L,) landmark l matched feature idx_b[l]
    f_of_l = mm.idx_b

    rays_l = jnp.stack([feats.ray_top[f_of_l], feats.ray_bottom[f_of_l]], axis=1)  # (L, 2, 3)
    obs_rays = obs_rays.at[new_head].set(jnp.where(assoc[:, None, None], rays_l, 0.0))
    obs_w = obs_w.at[new_head].set(jnp.where(assoc[:, None], 1.0, 0.0))
    lm_last_seen = jnp.where(assoc, kf_counter, m.lm_last_seen)

    # --- insert new landmarks into free/stale slots ---
    # Features not claimed by any landmark:
    claimed = jnp.zeros((feats.valid.shape[0],), bool).at[f_of_l].max(assoc)
    depth2 = jnp.sum(feats.pts_rig * feats.pts_rig, axis=-1)
    cand_score = jnp.where(feats.valid & ~claimed, 1.0 / (1.0 + depth2), -jnp.inf)
    cand_val, f_sel = jax.lax.top_k(cand_score, max_new)        # best new features
    # Slot priority: invalid slots first, then stalest.
    staleness = kf_counter - m.lm_last_seen
    slot_score = jnp.where(m.lm_valid, staleness.astype(jnp.float32), STALE_BIG)
    _, s_sel = jax.lax.top_k(slot_score, max_new)
    # Only overwrite ACTIVE slots if they are stale beyond the window.
    evictable = ~m.lm_valid[s_sel] | (staleness[s_sel] >= W)
    write = (cand_val > 0.0) & evictable                         # (max_new,)

    pts_world = transform_points(T_world, feats.pts_rig[f_sel])  # (max_new, 3)
    w3 = write[:, None]
    lm_pos = m.lm_pos.at[s_sel].set(jnp.where(w3, pts_world, m.lm_pos[s_sel]))
    lm_desc = m.lm_desc.at[s_sel].set(
        jnp.where(w3, feats.desc[f_sel], m.lm_desc[s_sel]))
    lm_valid = m.lm_valid.at[s_sel].set(write | m.lm_valid[s_sel])
    lm_last_seen = lm_last_seen.at[s_sel].set(
        jnp.where(write, kf_counter, lm_last_seen[s_sel]))
    # Evicted slots' old observations are dead -- zero them across the window.
    obs_w = obs_w.at[:, s_sel].multiply(jnp.where(write[None, :, None], 0.0, 1.0))
    obs_rays = obs_rays.at[:, s_sel].multiply(jnp.where(write[None, :, None, None], 0.0, 1.0))
    # ...then record the new landmarks' own first observation.
    new_rays = jnp.stack([feats.ray_top[f_sel], feats.ray_bottom[f_sel]], axis=1)
    obs_rays = obs_rays.at[new_head, s_sel].set(
        jnp.where(write[:, None, None], new_rays, obs_rays[new_head, s_sel]))
    obs_w = obs_w.at[new_head, s_sel].set(
        jnp.where(write[:, None], 1.0, obs_w[new_head, s_sel]))

    return MapState(
        kf_X=kf_X, kf_valid=kf_valid, kf_frame=kf_frame,
        head=new_head, n_kf=m.n_kf + 1,
        lm_pos=lm_pos, lm_desc=lm_desc, lm_valid=lm_valid,
        lm_last_seen=lm_last_seen, obs_rays=obs_rays, obs_w=obs_w,
    )


def window_anchor(m: MapState) -> jnp.ndarray:
    """Gauge keyframe slot: the OLDEST valid keyframe in the ring."""
    W = m.kf_X.shape[0]
    return jnp.where(m.n_kf < W, 0, jnp.mod(m.head + 1, W))


def run_window_ba(rig: OmnistereoRig, m: MapState, iters: int = 5,
                  axis_name: str | None = None,
                  huber_delta: float | None = 0.01) -> tuple[MapState, jnp.ndarray]:
    """Refine the window with robust BA; returns (updated map, BA cost)."""
    vps = jnp.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    win = BAWindow(X=m.kf_X, landmarks=m.lm_pos, rays=m.obs_rays,
                   weights=m.obs_w, viewpoints=vps)
    res = ba_solve(win, iters=iters, axis_name=axis_name,
                   anchor=window_anchor(m), huber_delta=huber_delta)
    return m._replace(kf_X=res.X, lm_pos=res.landmarks), res.cost
