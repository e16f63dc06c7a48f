"""Image-mode VO: raw omni images -> frontend -> the same core step.

Benchmark config c2 (BASELINE.json:8: full frontend detect+match). The
reference's per-frame driver crosses OpenCV C++ boundaries for remap/detect/
describe/match every frame (SURVEY.md section 3.1); here the frontend
(`sosvo/frontend/image_frontend.py`) composes with the observation-mode core
step into ONE jitted function, so a full image-mode frame -- panorama warp,
Harris, BRIEF, stereo+temporal Hamming matching, triangulation, RANSAC,
refine -- is a single XLA program, scanned over frames in replay.
"""

from __future__ import annotations

import jax

from sosvo.frontend.image_frontend import FrontendLUTs, build_frontend_luts, extract_observations
from sosvo.sensor.rig import OmnistereoRig
from sosvo.utils.config import PipelineConfig
from sosvo.vo.pipeline import step
from sosvo.vo.state import StepOutput, TrackState


def image_step(
    rig: OmnistereoRig,
    luts: FrontendLUTs,
    cfg: PipelineConfig,
    state: TrackState,
    image: jax.Array,
) -> tuple[TrackState, StepOutput]:
    """One VO frame from a raw omnidirectional image. Pure; jit/scan-safe."""
    obs = extract_observations(rig, luts, cfg.frontend, image)
    # Fusion firewall: cross-stage fusion of the image-frontend ops with the
    # geometry step can rematerialize image-sized intermediates inside the
    # matcher/RANSAC region. The barrier keeps one dispatch but separate
    # schedules.
    obs = jax.lax.optimization_barrier(obs)
    return step(rig, cfg, state, obs)


def image_step_ba(
    rig: OmnistereoRig,
    luts: FrontendLUTs,
    cfg: PipelineConfig,
    state,
    image: jax.Array,
    ba_fn=None,
):
    """One keyframed windowed-BA VO frame from a raw omni image.

    The live driver's BA mode (`vo/live.py:live_vo_ba`) jits exactly this:
    frontend extraction (same fusion firewall as `image_step`) feeding
    `step_ba`'s keyframe-map / window-solve logic, so a streaming source
    gets the same map-backed trajectory the replay path produces
    (SURVEY.md C15's two execution modes x the BA backend; VERDICT r3
    missing #2)."""
    from sosvo.vo.ba_pipeline import step_ba

    obs = extract_observations(rig, luts, cfg.frontend, image)
    obs = jax.lax.optimization_barrier(obs)
    return step_ba(rig, cfg, state, obs, ba_fn=ba_fn)


def run_replay_images(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    state: TrackState,
    images: jax.Array,
    luts: FrontendLUTs | None = None,
    split: bool = True,
) -> tuple[TrackState, StepOutput]:
    """Replay a raw-image sequence (stacked per-frame outputs).

    `split=True` (default): extract observations for all frames with
    `lax.map`, then scan the geometry core over them (XLA schedules the
    image region and the geometry region of one fused scan body poorly).
    `split=False` keeps the single fused scan (lower peak memory: no stacked
    observations; use for very long in-device sequences).
    """
    if luts is None:
        luts = build_frontend_luts(rig, cfg.frontend)

    if split:
        from sosvo.vo.pipeline import run_replay

        obs = jax.lax.map(
            lambda im: extract_observations(rig, luts, cfg.frontend, im), images)
        return run_replay(rig, cfg, state, obs)

    def body(s, img):
        return image_step(rig, luts, cfg, s, img)

    return jax.lax.scan(body, state, images)
