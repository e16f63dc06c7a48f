"""Batched multi-sequence replay: vmap over sequences, sharded on "data".

Benchmark config c4 (BASELINE.json:10: "4 sequences in parallel via vmap with
shared ... kernels, 1 host"). The per-frame step is already pure over pytrees,
so batching is `jax.vmap` over a leading sequence axis; placing that axis on
the mesh's "data" axis (SURVEY.md P1-DP) makes XLA partition every kernel --
matcher, RANSAC, refine -- across devices with zero code changes. On one
device the vmap still pays off: the matcher's matmuls and the RANSAC batch
grow by the sequence count, improving hardware utilization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sosvo.dist.mesh import DATA_AXIS
from sosvo.sensor.rig import OmnistereoRig
from sosvo.synth.scene import FrameObservations
from sosvo.utils.config import PipelineConfig
from sosvo.vo.pipeline import step
from sosvo.vo.state import StepOutput, TrackState, init_track_state


def init_batched_states(n_seq: int, max_features: int, key: jax.Array,
                        T0: jnp.ndarray | None = None) -> TrackState:
    """Stacked TrackStates, leading axis = sequence."""
    keys = jax.random.split(key, n_seq)
    T0s = jnp.tile(jnp.eye(4, dtype=jnp.float32), (n_seq, 1, 1)) if T0 is None else T0
    return jax.vmap(lambda k, T: init_track_state(max_features, k, T0=T))(keys, T0s)


def run_replay_batched(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    states: TrackState,
    obs_seqs: FrameObservations,
) -> tuple[TrackState, StepOutput]:
    """Replay S sequences in lockstep: obs fields are (S, F, ...).

    Scan over frames of a vmapped step (scan-of-vmap, not vmap-of-scan, so
    the compiled program is a single loop whose body is batch-parallel --
    the layout that shards cleanly over the "data" mesh axis).

    The essential gate is DEFERRED out of the vmapped step and applied with
    one any(lane.need) `lax.cond` per scan step (`apply_deferred_gate`): a
    per-lane lazy cond would lower to select under vmap and run the 2D-2D
    RANSAC for every lane every frame.
    """
    from sosvo.vo.pipeline import apply_deferred_gate, step_full

    def body(s, o):
        T_world_old = s.T_world                       # (S, 4, 4) pre-step
        s2, out, _feats, ctx = jax.vmap(
            lambda st, ob: step_full(rig, cfg, st, ob, defer_gate=True))(s, o)
        s2, out = apply_deferred_gate(cfg, T_world_old, s2, out, ctx)
        return s2, out

    obs_fmajor = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), obs_seqs)  # (F, S, ...)
    final, outs = jax.lax.scan(body, states, obs_fmajor)
    return final, jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), outs)     # (S, F, ...)


def init_batched_ba_states(n_seq: int, cfg: PipelineConfig, key: jax.Array,
                           T0: jnp.ndarray | None = None):
    """Stacked BAStates (track + keyframe map), leading axis = sequence."""
    from sosvo.vo.ba_pipeline import init_ba_state

    keys = jax.random.split(key, n_seq)
    T0s = jnp.tile(jnp.eye(4, dtype=jnp.float32), (n_seq, 1, 1)) if T0 is None else T0
    return jax.vmap(lambda k, T: init_ba_state(cfg, k, T0=T))(keys, T0s)


def run_replay_ba_batched(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    states,
    obs_seqs: FrameObservations,
    ba_fn=None,
    insert_fn=None,
):
    """Replay S sequences in lockstep WITH windowed BA (B:10's full contract:
    the batched path shares the Schur/BA kernels, not just the f2f step).

    MapState is a fixed-shape pytree, so `jax.vmap(step_ba)` batches the
    keyframe map, landmark insertion, and the window solve per sequence with
    no code changes; on the "data" mesh every BA matmul partitions like the
    f2f kernels do.

    Keyframing is forced to the LOCKSTEP STRIDE schedule: all lanes start at
    the same frame index, so the stride decision is one scalar per scan step,
    computed OUTSIDE the vmap and passed via `is_kf_override` -- keeping the
    keyframe `lax.cond` a real cond (a per-lane predicate would lower to
    select and run the BA solve every frame for every lane). Adaptive
    keyframing is per-lane by nature and therefore not supported batched;
    callers get the stride schedule regardless of `cfg.keyframe_mode`.

    The essential gate is likewise deferred out of the vmapped f2f core and
    resolved once per scan step (`pipeline.apply_deferred_gate`) BEFORE the
    keyframe stage consumes the pose -- both the gate skip and the keyframe
    cond stay real conditionals in the batched program.

    `ba_fn` / `insert_fn` override the window solve / keyframe insertion
    per lane (bench ablation + distributed callers).

    The WHOLE keyframe stage (insert + window solve + pose correction) sits
    under ONE scalar `lax.cond` per scan step, OUTSIDE the vmap, with the
    vmap inside each branch -- and the window-warmup decision (n_kf >= 2,
    lane-uniform in lockstep) is likewise a scalar cond. The earlier
    structure vmapped `step_ba_post` whole, which kept the outer cond alive
    (unbatched predicate) but paid a measured ~0.12 ms/frame of structural
    overhead even with insert AND solve stubbed out, and lowered the
    per-lane n_kf cond to select (VERDICT r4 #3).
    """
    from sosvo.frontend.match import metric_params
    from sosvo.geom.lie import mat_inv
    from sosvo.vo.ba_pipeline import BAState, BAStepOutput
    from sosvo.vo.keyframes import insert_keyframe, run_window_ba
    from sosvo.vo.pipeline import apply_deferred_gate, step_full

    metric, max_dist = metric_params(cfg.frontend)
    ins = insert_fn if insert_fn is not None else insert_keyframe

    def solve(mm):
        if ba_fn is not None:
            return ba_fn(mm)
        return run_window_ba(rig, mm, iters=cfg.ba.iters,
                             huber_delta=cfg.ba.huber_delta)

    def body(s, o):
        # Lanes are in lockstep: lane 0's frame counter IS the scalar frame.
        frame = s.track.frame_idx[0]
        is_kf = jnp.mod(frame, cfg.keyframe_every) == 0
        T_world_old = s.track.T_world                 # (S, 4, 4) pre-step
        track2, out, feats, ctx = jax.vmap(
            lambda st, ob: step_full(rig, cfg, st, ob, defer_gate=True))(
            s.track, o)
        track2, out = apply_deferred_gate(cfg, T_world_old, track2, out, ctx)

        if cfg.relocalize:
            # Deferred-hoist (the apply_deferred_gate pattern): ONE scalar
            # any-lane-lost decision per scan step; only then the vmapped
            # map-match + RANSAC runs (as select inside, which is fine --
            # the branch is rare and the scalar cond skips it entirely on
            # healthy steps).
            from sosvo.vo.ba_pipeline import try_relocalize

            need_any = jnp.any((~out.pose_ok) & (s.map.n_kf >= 1))
            track2, out = jax.lax.cond(
                need_any,
                lambda args: jax.vmap(
                    lambda m, t, ou2, f: try_relocalize(cfg, m, t, ou2, f))(
                    *args),
                lambda args: (args[1], args[2]),
                (s.map, track2, out, feats))

        def kf_stage(args):
            maps, tr, fe = args
            maps = jax.vmap(lambda m, Tw, f: ins(
                m, Tw, f, frame,
                max_new=cfg.ba.max_new,
                match_max_distance=max_dist,
                match_ratio=cfg.frontend.match_ratio,
                metric=metric))(maps, tr.T_world, fe)

            def run_ba(ms):
                m2, cost = jax.vmap(solve)(ms)
                return m2, cost

            # Lockstep => n_kf is lane-uniform; one scalar warmup decision.
            maps, cost = jax.lax.cond(
                maps.n_kf[0] >= 2, run_ba,
                lambda ms: (ms, jnp.zeros((tr.T_world.shape[0],),
                                          jnp.float32)), maps)
            T_w = jax.vmap(lambda m: mat_inv(m.kf_X[m.head]))(maps)
            return maps, T_w, cost

        def no_stage(args):
            maps, tr, _ = args
            S = tr.T_world.shape[0]
            return maps, tr.T_world, jnp.zeros((S,), jnp.float32)

        map2, T_w, cost = jax.lax.cond(is_kf, kf_stage, no_stage,
                                       (s.map, track2, feats))
        track2 = track2._replace(T_world=T_w)
        out2 = BAStepOutput(
            vo=out._replace(T_world=T_w),
            is_keyframe=jnp.broadcast_to(is_kf, cost.shape),
            ba_cost=cost,
            n_landmarks=jnp.sum(map2.lm_valid.astype(jnp.int32), axis=-1),
        )
        return BAState(track=track2, map=map2), out2

    obs_fmajor = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), obs_seqs)  # (F, S, ...)
    final, outs = jax.lax.scan(body, states, obs_fmajor)
    return final, jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), outs)     # (S, F, ...)


def synthetic_batched_inputs(rig: OmnistereoRig, cfg: PipelineConfig,
                             n_seq: int, n_frames: int, n_landmarks: int, *,
                             pixel_noise: float, desc_flip_prob: float,
                             ba: bool, seed: int = 0):
    """`n_seq` synthetic sequences and their stacked initial states.

    Returns (states, obs, gt_poses) with a leading sequence axis; `ba`
    picks BA states (`run_replay_ba_batched`) over track states
    (`run_replay_batched`). Seed 0 gives the inputs of config c4.
    """
    from sosvo.synth.scene import make_scene, observe_sequence

    K = cfg.frontend.max_features
    keys = jax.random.split(jax.random.PRNGKey(seed), n_seq)
    scenes = [make_scene(k, n_frames=n_frames, n_landmarks=n_landmarks)
              for k in keys]
    obs = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[observe_sequence(rig, sc, K, k, pixel_noise=pixel_noise,
                           desc_flip_prob=desc_flip_prob)
          for sc, k in zip(scenes, keys)])
    gt = jnp.stack([sc.poses for sc in scenes])   # (S, F, 4, 4)
    key = jax.random.PRNGKey(seed + 2)
    states = (init_batched_ba_states(n_seq, cfg, key, T0=gt[:, 0]) if ba
              else init_batched_states(n_seq, K, key, T0=gt[:, 0]))
    return states, obs, gt


def shard_batched_inputs(mesh: Mesh, states: TrackState, obs_seqs: FrameObservations):
    """Place the sequence axis on the "data" mesh axis, everything else replicated."""

    def put(tree):
        def leaf(a):
            spec = P(DATA_AXIS) if getattr(a, "ndim", 0) >= 1 else P()
            return jax.device_put(a, NamedSharding(mesh, spec))
        return jax.tree.map(leaf, tree)

    return put(states), put(obs_seqs)
