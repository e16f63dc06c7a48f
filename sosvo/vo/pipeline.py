"""The VO state machine: one jitted per-frame step, scanned over frames.

JAX replacement for the reference's per-frame driver loop (SURVEY.md
C15 and SS3.1): acquire -> stereo match -> triangulate -> temporal match ->
RANSAC pose -> refine -> concatenate. In the reference each stage crosses an
OpenCV/scipy native boundary per frame; here the ENTIRE body is one jitted
pure function over fixed-shape pytrees, so XLA fuses the whole frame and
`lax.scan` replays a sequence with zero host round-trips (BASELINE.json:5
"the whole frontend+backend JITs end-to-end").

This module implements the observation-mode pipeline (config c1,
BASELINE.json:7): inputs are per-frame feature observations (rays +
descriptors), exactly what the image frontend produces. The image-mode
pipeline composes the panorama/detect/describe frontend in front of the same
core (`sosvo/vo/image_pipeline.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.backend.refine import refine_pose_bearings
from sosvo.frontend.match import column_band_penalty, match
from sosvo.geom.lie import geodesic_angle, mat_inv
from sosvo.geometry.ransac import ransac_essential, ransac_rigid
from sosvo.geometry.triangulate import midpoint_triangulate
from sosvo.sensor.model import viewpoint
from sosvo.sensor.rig import OmnistereoRig
from sosvo.synth.scene import FrameObservations
from sosvo.utils.config import PipelineConfig
from sosvo.vo.keyframes import KeyframeFeatures
from sosvo.vo.state import StepOutput, TrackState


def azimuth_of(rays: jnp.ndarray) -> jnp.ndarray:
    return jnp.arctan2(rays[..., 1], rays[..., 0])


def _match(cfg: PipelineConfig, desc_a, desc_b, valid_a, valid_b,
           az_a=None, az_b=None, band: float = 0.0):
    """Matcher dispatch: Hamming for binary descriptors, L2 for the SIFT
    float-descriptor option (SURVEY.md C6). The azimuth band constraint is a
    dense penalty matrix added to the distance matrix."""
    if cfg.frontend.descriptor == "sift":
        penalty = None
        if band > 0.0:
            penalty = column_band_penalty(az_a, az_b, band, wrap=2.0 * jnp.pi)
        return match(
            desc_a, desc_b, valid_a, valid_b,
            max_distance=cfg.frontend.match_max_distance_l2,
            ratio=cfg.frontend.match_ratio,
            penalty=penalty,
            metric="l2",
        )
    penalty = None
    if band > 0.0:
        penalty = column_band_penalty(az_a, az_b, band, wrap=2.0 * jnp.pi)
    return match(
        desc_a, desc_b, valid_a, valid_b,
        max_distance=cfg.frontend.match_max_distance,
        ratio=cfg.frontend.match_ratio,
        penalty=penalty,
    )


def stereo_triangulate(rig: OmnistereoRig, obs: FrameObservations, cfg: PipelineConfig):
    """Stereo match top vs bottom feature sets, triangulate matched pairs.

    Returns fixed-size (K,) arrays indexed by TOP feature slot: 3D point,
    descriptor, ray, azimuth, validity.
    """
    az_t = azimuth_of(obs.ray_top)
    az_b = azimuth_of(obs.ray_bottom)
    # Coaxial views: epipolar curves are iso-azimuth (SURVEY.md C5/C7 [P1]),
    # so stereo candidates must agree in azimuth (wrapped band).
    m = _match(
        cfg, obs.desc_top, obs.desc_bottom, obs.valid_top, obs.valid_bottom,
        az_a=az_t, az_b=az_b, band=cfg.frontend.stereo_band_rad,
    )
    ray_b = obs.ray_bottom[m.idx_b]
    tri = midpoint_triangulate(
        obs.ray_top, ray_b,
        viewpoint(rig.top), viewpoint(rig.bottom),
        min_angle=cfg.min_triangulation_angle,
        max_range=cfg.max_range,
        max_gap=cfg.max_ray_gap,
    )
    valid = m.valid & tri.valid
    return tri.points, obs.desc_top, obs.ray_top, az_t, valid, ray_b


class GateCtx(NamedTuple):
    """Everything the essential gate needs, detached from the step.

    The batched replay hoists ONE gate decision outside its vmap
    (`any(lane.need)` -> scalar `lax.cond`), which a per-lane cond cannot do
    -- vmap lowers cond to select and BOTH branches run every frame for
    every lane. See `apply_deferred_gate`.
    """

    need: jnp.ndarray        # () bool: this frame wants the cross-check
    key: jax.Array           # the step's k_ess stream
    prev_rays: jnp.ndarray   # (K, 3)
    rays_curr: jnp.ndarray   # (K, 3) temporally matched current rays
    pair_valid: jnp.ndarray  # (K,)
    R_rigid: jnp.ndarray     # (3, 3) refined rigid rotation to check against


def _gate_check(cfg: PipelineConfig, ctx: GateCtx):
    """(consistent, angle): the essential cross-check body (SURVEY.md C9)."""
    re, R_e, _t = ransac_essential(
        ctx.key, ctx.prev_rays, ctx.rays_curr, ctx.pair_valid,
        n_hyps=cfg.ransac.n_hyps,
        threshold=cfg.ransac.essential_threshold,
        min_inliers=cfg.ransac.min_inliers,
    )
    angle = geodesic_angle(ctx.R_rigid, R_e)
    return jnp.where(re.ok, angle < 0.15, True), angle


def step_full(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    state: TrackState,
    obs: FrameObservations,
    defer_gate: bool = False,
):
    """One VO frame; also returns the frame's triangulated features so the
    keyframe/BA layer (`sosvo/vo/keyframes.py`) can consume them without
    recomputing the frontend.

    `defer_gate=True` (trace-time flag) skips the essential gate entirely
    and appends its `GateCtx` to the return, as if every frame were
    consistent; the caller MUST then run `apply_deferred_gate` on the
    result before the next step consumes the state (the batched replay does
    this with one any(need) cond hoisted outside its vmap)."""
    key, k_ransac, k_ess = jax.random.split(state.key, 3)

    # --- stereo + triangulation (SURVEY.md SS3.2) ---
    pts, desc, rays, az, valid, ray_b = stereo_triangulate(rig, obs, cfg)
    n_stereo = jnp.sum(valid.astype(jnp.int32))

    # --- temporal match: previous frame's points vs current features ---
    tm = _match(cfg, state.prev_desc, desc, state.prev_valid, valid)
    pts_curr_m = pts[tm.idx_b]
    rays_curr_m = rays[tm.idx_b]
    pair_valid = tm.valid & state.prev_valid & valid[tm.idx_b]
    n_temporal = jnp.sum(pair_valid.astype(jnp.int32))

    # --- robust relative pose: T_cp (current-from-previous), 3D-3D (SS3.3) ---
    rr = ransac_rigid(
        k_ransac, state.prev_points, pts_curr_m, pair_valid,
        rays_curr=rays_curr_m,
        n_hyps=cfg.ransac.n_hyps,
        threshold=cfg.ransac.rigid_threshold,
        angle_threshold=cfg.ransac.rigid_angle_threshold,
        min_inliers=cfg.ransac.min_inliers,
    )

    # --- bearing-only refinement on inliers (SURVEY.md C12) ---
    w = rr.inliers.astype(jnp.float32)
    T_cp = refine_pose_bearings(rr.model, state.prev_points, rays_curr_m, w, iters=cfg.refine_iters)

    # --- essential-matrix gate (2D-2D path, SURVEY.md C9; config c1) ---
    frac = rr.num_inliers.astype(jnp.float32) / jnp.maximum(
        n_temporal.astype(jnp.float32), 1.0)
    gate_ctx = GateCtx(need=(frac < cfg.lazy_gate_ratio) | ~rr.ok,
                       key=k_ess, prev_rays=state.prev_rays,
                       rays_curr=rays_curr_m, pair_valid=pair_valid,
                       R_rigid=T_cp[:3, :3])
    if defer_gate or not cfg.use_essential_gate:
        ess_angle = jnp.float32(0.0)
        ess_consistent = jnp.asarray(True)
    else:
        if cfg.lazy_essential_gate:
            # Adaptive skip: a confidently-tracked frame (high rigid inlier
            # fraction) does not pay for the 2D-2D cross-check -- ~0.45 ms
            # of a ~1 ms frame. lax.cond executes ONE branch at runtime in
            # the replay scan. The failure the gate exists to catch -- a
            # rigid pose biased by triangulation-depth noise -- drops the
            # inlier fraction first, so questionable frames still run the
            # full gate (threshold swept in tests/test_pipeline_c1.py::
            # test_lazy_gate_*). Batched callers use `step_full_ctx` +
            # `apply_deferred_gate` instead: under vmap this cond lowers to
            # select (both branches every lane); hoisting one any(need)
            # decision outside the vmap keeps the skip real.
            ess_consistent, ess_angle = jax.lax.cond(
                gate_ctx.need, lambda c: _gate_check(cfg, c),
                lambda c: (jnp.asarray(True), jnp.float32(0.0)),
                gate_ctx)
        else:
            ess_consistent, ess_angle = _gate_check(cfg, gate_ctx)

    pose_ok = rr.ok & ess_consistent
    # On failure hold the pose (identity relative motion) rather than
    # propagating a garbage estimate -- same recovery the reference's
    # frame-to-frame loop uses on tracking loss.
    T_cp = jnp.where(pose_ok, T_cp, jnp.eye(4, dtype=T_cp.dtype))
    T_world = state.T_world @ mat_inv(T_cp)

    new_state = TrackState(
        T_world=T_world,
        prev_points=pts,
        prev_desc=desc,
        prev_rays=rays,
        prev_azimuth=az,
        prev_valid=valid,
        frame_idx=state.frame_idx + 1,
        key=key,
    )
    out = StepOutput(
        T_world=T_world,
        n_stereo=n_stereo,
        n_temporal=n_temporal,
        n_inliers=rr.num_inliers,
        pose_ok=pose_ok,
        ess_angle_err=ess_angle,
    )
    feats = KeyframeFeatures(pts_rig=pts, desc=desc, ray_top=rays,
                             ray_bottom=ray_b, valid=valid)
    if defer_gate:
        return new_state, out, feats, gate_ctx
    return new_state, out, feats


def apply_deferred_gate(
    cfg: PipelineConfig,
    T_world_old: jnp.ndarray,
    new_state: TrackState,
    out: StepOutput,
    ctx: GateCtx,
):
    """Run the hoisted essential gate over a BATCH of deferred steps.

    Inputs carry a leading lane axis (`T_world_old` = each lane's pose
    BEFORE the step). One scalar any(need) `lax.cond` guards the vmapped
    gate, so a batch where every lane tracks confidently skips the 2D-2D
    RANSAC entirely -- the per-lane cond inside `step_full` cannot do this
    (vmap lowers it to select and both branches execute for all lanes).
    Lanes the gate rejects revert to the identity-hold recovery the inline
    path applies: pose (and carry) fall back to the pre-step pose.
    """
    n_lanes = ctx.need.shape[0]

    def run(c):
        return jax.vmap(lambda cc: _gate_check(cfg, cc))(c)

    def skip(c):
        return (jnp.ones((n_lanes,), bool), jnp.zeros((n_lanes,), jnp.float32))

    if cfg.use_essential_gate and cfg.lazy_essential_gate:
        ess_ok, ess_angle = jax.lax.cond(jnp.any(ctx.need), run, skip, ctx)
        # Confident lanes keep the skip semantics of the inline path even
        # when another lane triggered the batch gate: their verdict is True
        # and their reported angle 0, exactly as the per-frame cond yields.
        ess_ok = jnp.where(ctx.need, ess_ok, True)
        ess_angle = jnp.where(ctx.need, ess_angle, 0.0)
    elif cfg.use_essential_gate:
        ess_ok, ess_angle = run(ctx)
    else:
        ess_ok, ess_angle = skip(ctx)

    pose_ok = out.pose_ok & ess_ok
    T_world = jnp.where(pose_ok[:, None, None], out.T_world, T_world_old)
    new_state = new_state._replace(T_world=T_world)
    out = out._replace(T_world=T_world, pose_ok=pose_ok, ess_angle_err=ess_angle)
    return new_state, out


def step(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    state: TrackState,
    obs: FrameObservations,
) -> tuple[TrackState, StepOutput]:
    """One VO frame: returns (new_state, output). Pure; jit/scan/vmap-safe."""
    new_state, out, _ = step_full(rig, cfg, state, obs)
    return new_state, out


def run_replay(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    state: TrackState,
    obs_seq: FrameObservations,
) -> tuple[TrackState, StepOutput]:
    """Replay a whole sequence with lax.scan; outputs are stacked per frame."""

    def body(s, o):
        return step(rig, cfg, s, o)

    return jax.lax.scan(body, state, obs_seq)
