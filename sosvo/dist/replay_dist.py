"""Landmark-sharded replay: the c5 composition as ONE jitted program.

Benchmark config c5 (BASELINE.json:11) demands "landmark blocks sharded
across N >= 2 hosts with distributed Schur-complement BA over collectives"
*as a replay*, not as an isolated solver benchmark. This module composes the
keyframed VO replay (`sosvo/vo/ba_pipeline.py`) with the landmark-sharded BA
solve (`sosvo/dist/ba_dist.py`): the tracking/association state machine runs
replicated (it is a few percent of the frame cost), and every keyframe's
window solve executes under `shard_map` on the mesh's "model" axis -- each
device reduces its landmark shard's camera-system contribution, partial
(S, b) blocks psum across the cards, the small camera solve replicates, and
back-substitution is shard-local (SURVEY.md section 3.4's device-boundary
diagram, now inside the replay scan).

Correctness invariant (tests/test_replay_dist.py): the sharded replay's
trajectory equals the single-device replay's to f32 reduction tolerance --
frame for frame, because the solves see identical windows.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sosvo.backend.ba import BAResult, BAWindow, ba_solve
from sosvo.dist.ba_dist import _window_specs
from sosvo.dist.mesh import MODEL_AXIS
from sosvo.sensor.model import viewpoint
from sosvo.sensor.rig import OmnistereoRig
from sosvo.synth.scene import FrameObservations
from sosvo.utils.config import PipelineConfig
from sosvo.vo.ba_pipeline import BAState, BAStepOutput, run_replay_ba
from sosvo.vo.keyframes import MapState, window_anchor


def make_sharded_ba_fn(mesh: Mesh, rig: OmnistereoRig, cfg: PipelineConfig):
    """A MapState -> (MapState, cost) window solve sharded over `mesh`.

    Drop-in for `step_ba`'s `ba_fn`: builds the BAWindow from the map state,
    solves it under shard_map with landmarks on the "model" axis, and writes
    the refined poses/landmarks back. The map's landmark capacity
    (`cfg.ba.max_landmarks`) must be divisible by the model-axis size.
    """
    n_model = mesh.shape[MODEL_AXIS]
    if cfg.ba.max_landmarks % n_model != 0:
        raise ValueError(
            f"max_landmarks={cfg.ba.max_landmarks} not divisible by the "
            f"model axis ({n_model})")

    win_specs = _window_specs()
    res_specs = BAResult(X=P(), landmarks=P(MODEL_AXIS), cost=P(), cost0=P(),
                         accepted=P())
    def _solve(win, anchor):
        return ba_solve(win, iters=cfg.ba.iters, axis_name=MODEL_AXIS,
                        anchor=anchor, huber_delta=cfg.ba.huber_delta)

    solve = shard_map(
        _solve,
        mesh=mesh,
        in_specs=(win_specs, P()),
        out_specs=res_specs,
        # Same vma situation as ba_solve_sharded (sosvo/dist/ba_dist.py):
        # replicated outputs flow through data-dependent accept/reject
        # control the static checker cannot prove; equality across shards is
        # asserted dynamically against the single-device replay instead.
        check_vma=False,
    )
    vps = jnp.stack([viewpoint(rig.top), viewpoint(rig.bottom)])

    def ba_fn(m: MapState):
        win = BAWindow(X=m.kf_X, landmarks=m.lm_pos, rays=m.obs_rays,
                       weights=m.obs_w, viewpoints=vps)
        res = solve(win, window_anchor(m))
        return m._replace(kf_X=res.X, lm_pos=res.landmarks), res.cost

    return ba_fn


def run_replay_ba_sharded(
    mesh: Mesh,
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    state: BAState,
    obs_seq: FrameObservations,
) -> tuple[BAState, BAStepOutput]:
    """`run_replay_ba` with every keyframe BA solve landmark-sharded."""
    ba_fn = make_sharded_ba_fn(mesh, rig, cfg)
    return run_replay_ba(rig, cfg, state, obs_seq, ba_fn=ba_fn)
