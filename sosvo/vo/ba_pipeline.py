"""VO with sliding-window bundle adjustment (benchmark config c2 core).

Wraps the frame-to-frame step (`sosvo/vo/pipeline.py`) with the keyframe map
manager (`sosvo/vo/keyframes.py`): every `keyframe_every`-th frame becomes a
keyframe -- landmarks are associated/inserted and the W-keyframe window is
refined by Schur-complement LM BA -- all inside `lax.cond` so the whole
replay remains ONE jitted scan (the reference would cross a scipy
least-squares boundary here per window; SURVEY.md C13).

The BA pose correction feeds back into the tracking state: the current pose
is re-read from the refined window, so subsequent frame-to-frame estimates
compound on the optimized trajectory.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.frontend.match import metric_params
from sosvo.geom.lie import mat_inv
from sosvo.sensor.rig import OmnistereoRig
from sosvo.synth.scene import FrameObservations
from sosvo.utils.config import PipelineConfig
from sosvo.vo.keyframes import MapState, init_map_state, insert_keyframe, run_window_ba
from sosvo.vo.pipeline import step_full
from sosvo.vo.state import StepOutput, TrackState, init_track_state


class BAState(NamedTuple):
    track: TrackState
    map: MapState


class BAStepOutput(NamedTuple):
    vo: StepOutput
    is_keyframe: jnp.ndarray  # () bool
    ba_cost: jnp.ndarray      # () f32 (0 when not a keyframe)
    n_landmarks: jnp.ndarray  # () int32 active landmark count


def init_ba_state(cfg: PipelineConfig, key: jax.Array, T0=None) -> BAState:
    return BAState(
        track=init_track_state(cfg.frontend.max_features, key, T0=T0,
                         descriptor=cfg.frontend.descriptor),
        map=init_map_state(cfg.ba.window, cfg.ba.max_landmarks, cfg.frontend.descriptor),
    )


def step_ba(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    state: BAState,
    obs: FrameObservations,
    ba_fn=None,
    is_kf_override: jnp.ndarray | None = None,
) -> tuple[BAState, BAStepOutput]:
    """One frame with keyframe/BA logic. Pure; jit/scan-safe.

    `ba_fn` (MapState -> (MapState, cost)) overrides the window solve --
    the distributed replay (`sosvo/dist/replay_dist.py`) passes a
    shard_map'd landmark-sharded Schur solve here (config c5).

    `is_kf_override`: a SCALAR keyframe decision computed outside this
    function. The batched replay (`vo/batched.py:run_replay_ba_batched`)
    passes the lockstep stride decision as an UNBATCHED scalar so the
    keyframe `lax.cond` below survives vmap as a cond -- with a per-lane
    (batched) predicate vmap lowers cond to select and BOTH branches
    (including the window BA solve) would execute every frame."""
    track, out, feats = step_full(rig, cfg, state.track, obs)
    return step_ba_post(rig, cfg, state, track, out, feats,
                        ba_fn=ba_fn, is_kf_override=is_kf_override)


def try_relocalize(cfg: PipelineConfig, m, track, out, feats):
    """Map-based pose re-acquisition on a lost frame (cond-gated).

    Matches the current frame's stereo-triangulated features against the
    landmark map and solves world->rig by 3D-3D RANSAC on the (world
    landmark, rig-frame triangulation) pairs; on success the track pose and
    the frame's pose_ok are overwritten. Fixed shapes throughout -- the map
    descriptor table has L slots, the frame K, so the match is one L x K
    Hamming (or L2) matrix exactly like keyframe association.
    """
    from sosvo.geometry.ransac import ransac_rigid
    from sosvo.frontend.match import match

    need = (~out.pose_ok) & (m.n_kf >= 1)

    def attempt(args):
        m, track, feats = args
        metric, max_dist = metric_params(cfg.frontend)
        mm = match(m.lm_desc, feats.desc, m.lm_valid, feats.valid,
                   max_distance=max_dist, ratio=cfg.frontend.match_ratio,
                   metric=metric)
        pv = mm.valid & m.lm_valid & feats.valid[mm.idx_b]
        key = jax.random.fold_in(track.key, 0x5e10c)
        rr = ransac_rigid(
            key, m.lm_pos, feats.pts_rig[mm.idx_b], pv,
            rays_curr=feats.ray_top[mm.idx_b],
            n_hyps=cfg.ransac.n_hyps,
            angle_threshold=cfg.ransac.rigid_angle_threshold,
            min_inliers=cfg.reloc_min_inliers,
        )
        T_w = mat_inv(rr.model)  # model: rig-from-world
        return T_w, rr.ok, rr.num_inliers

    def skip(args):
        _, track, _ = args
        return track.T_world, jnp.asarray(False), jnp.asarray(0, jnp.int32)

    T_reloc, reloc_ok, n_inl = jax.lax.cond(need, attempt, skip,
                                            (m, track, feats))
    T_new = jnp.where(reloc_ok, T_reloc, track.T_world)
    track = track._replace(T_world=T_new)
    out = out._replace(T_world=T_new, pose_ok=out.pose_ok | reloc_ok,
                       n_inliers=jnp.where(reloc_ok, n_inl, out.n_inliers))
    return track, out


def step_ba_post(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    state: BAState,
    track,
    out,
    feats,
    ba_fn=None,
    is_kf_override: jnp.ndarray | None = None,
    insert_fn=None,
) -> tuple[BAState, BAStepOutput]:
    """Keyframe/window-BA stage given an already-computed (and GATED) f2f
    step result. Split out so the batched replay can run the vmapped f2f
    core with `defer_gate=True`, resolve the essential gate ONCE per scan
    step outside the vmap (`pipeline.apply_deferred_gate`), and only then
    let the keyframe stage consume the post-gate pose -- a keyframe must
    never be inserted at a pose the gate is about to revert."""
    frame = track.frame_idx - 1  # index of the frame just processed

    # --- relocalization (SURVEY.md C15 recovery; r5) -------------------
    # A lost frame under pure f2f VO can only identity-hold; if the rig
    # moved during the dropout the trajectory keeps a permanent offset.
    # With a landmark map the ABSOLUTE pose is recoverable: match this
    # frame's stereo features against the map descriptors, 3D-3D RANSAC
    # the world-frame landmarks onto the rig-frame triangulations, accept
    # on a strict inlier count. Runs BEFORE keyframing so a recovered pose
    # (not the stale hold) is what gets keyframed. The cond predicate is
    # False on every tracked frame, so the replay scan pays nothing then.
    if cfg.relocalize:
        track, out = try_relocalize(cfg, state.map, track, out, feats)

    if is_kf_override is not None:
        is_kf = is_kf_override
    elif cfg.keyframe_mode == "adaptive":
        # Motion-adaptive trigger (SURVEY.md C15 keyframe logic; COMPAT #11):
        # keyframe when accumulated motion since the LAST keyframe crosses a
        # translation/rotation threshold, with a max-gap forcing function so
        # a hovering rig still refreshes its window. Mask-disciplined: pure
        # arithmetic on the ring state, no data-dependent shapes.
        from sosvo.geom.lie import geodesic_angle

        X_last = state.map.kf_X[state.map.head]          # rig-from-world
        rel = X_last @ track.T_world                     # last-rig <- now-rig
        trans = jnp.linalg.norm(rel[:3, 3])
        rot = geodesic_angle(rel[:3, :3], jnp.eye(3, dtype=rel.dtype))
        gap = frame - state.map.kf_frame[state.map.head]
        moved = (trans > cfg.kf_trans_thresh) | (rot > cfg.kf_rot_thresh)
        is_kf = (state.map.n_kf == 0) | (
            (gap >= cfg.kf_min_gap) & (moved | (gap >= cfg.kf_max_gap)))
    else:
        is_kf = jnp.mod(frame, cfg.keyframe_every) == 0

    def do_keyframe(m: MapState):
        metric, max_dist = metric_params(cfg.frontend)
        ins = insert_fn if insert_fn is not None else insert_keyframe
        m = ins(
            m, track.T_world, feats, frame,
            max_new=cfg.ba.max_new,
            match_max_distance=max_dist,
            match_ratio=cfg.frontend.match_ratio,
            metric=metric,
        )
        # Skip BA until the window has >= 2 keyframes (nothing to adjust).
        def ba(mm):
            if ba_fn is not None:
                return ba_fn(mm)
            mm2, cost = run_window_ba(rig, mm, iters=cfg.ba.iters,
                                      huber_delta=cfg.ba.huber_delta)
            return mm2, cost

        m, cost = jax.lax.cond(m.n_kf >= 2, ba, lambda mm: (mm, jnp.float32(0.0)), m)
        T_corr = mat_inv(m.kf_X[m.head])
        return m, T_corr, cost

    def no_keyframe(m: MapState):
        return m, track.T_world, jnp.float32(0.0)

    map2, T_w, cost = jax.lax.cond(is_kf, do_keyframe, no_keyframe, state.map)
    track = track._replace(T_world=T_w)

    out2 = BAStepOutput(
        vo=out._replace(T_world=T_w),
        is_keyframe=is_kf,
        ba_cost=cost,
        n_landmarks=jnp.sum(map2.lm_valid.astype(jnp.int32)),
    )
    return BAState(track=track, map=map2), out2


def run_replay_ba(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    state: BAState,
    obs_seq: FrameObservations,
    ba_fn=None,
) -> tuple[BAState, BAStepOutput]:
    """Replay with windowed BA; outputs stacked per frame."""

    def body(s, o):
        return step_ba(rig, cfg, s, o, ba_fn=ba_fn)

    return jax.lax.scan(body, state, obs_seq)
