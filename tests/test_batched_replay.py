"""Batched multi-sequence replay (config c4): vmap + "data"-axis sharding.

Invariants: batched replay == per-sequence replay (same RNG streams), and the
data-sharded run on the 8-device CPU mesh produces identical trajectories.
"""

import jax
import jax.numpy as jnp

from sosvo.dist.mesh import data_mesh
from sosvo.eval.ate import ate_rmse
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_sequence
from sosvo.utils.config import PipelineConfig
from sosvo.vo.batched import init_batched_states, run_replay_batched, shard_batched_inputs
from sosvo.vo.pipeline import run_replay
from sosvo.vo.state import init_track_state

S, F, K = 4, 8, 256


def _problem():
    rig = default_rig()
    cfg = PipelineConfig()
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    scenes = [make_scene(k, n_frames=F, n_landmarks=2048) for k in keys]
    obs = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[observe_sequence(rig, sc, K, k, pixel_noise=0.2, desc_flip_prob=0.01)
          for sc, k in zip(scenes, keys)],
    )
    states = init_batched_states(
        S, K, jax.random.PRNGKey(1),
        T0=jnp.stack([sc.poses[0] for sc in scenes]),
    )
    return rig, cfg, scenes, obs, states


def test_batched_equals_sequential():
    rig, cfg, scenes, obs, states = _problem()
    _, outs_b = jax.jit(lambda s, o: run_replay_batched(rig, cfg, s, o))(states, obs)
    for i in range(S):
        st = jax.tree.map(lambda x: x[i], states)
        ob = jax.tree.map(lambda x: x[i], obs)
        _, outs_1 = jax.jit(lambda s, o: run_replay(rig, cfg, s, o))(st, ob)
        assert float(jnp.max(jnp.abs(outs_b.T_world[i] - outs_1.T_world))) < 1e-5


def test_batched_tracks_all_sequences():
    rig, cfg, scenes, obs, states = _problem()
    _, outs = jax.jit(lambda s, o: run_replay_batched(rig, cfg, s, o))(states, obs)
    assert bool(jnp.all(outs.pose_ok[:, 1:]))
    for i in range(S):
        rmse, _ = ate_rmse(outs.T_world[i, 1:, :3, 3], scenes[i].poses[1:, :3, 3])
        assert float(rmse) < 0.05


def test_batched_data_sharded(devices8):
    rig, cfg, scenes, obs, states = _problem()
    mesh = data_mesh(4)
    states_s, obs_s = shard_batched_inputs(mesh, states, obs)
    _, outs_s = jax.jit(lambda s, o: run_replay_batched(rig, cfg, s, o))(states_s, obs_s)
    _, outs = jax.jit(lambda s, o: run_replay_batched(rig, cfg, s, o))(states, obs)
    assert float(jnp.max(jnp.abs(outs_s.T_world - outs.T_world))) < 1e-5


def _ba_problem():
    from sosvo.utils.config import BAConfig, FrontendConfig, RansacConfig
    from sosvo.vo.batched import init_batched_ba_states

    rig = default_rig()
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=K),
                         ransac=RansacConfig(n_hyps=256),
                         ba=BAConfig(window=4, max_landmarks=512, iters=3),
                         keyframe_every=3)
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    scenes = [make_scene(k, n_frames=F, n_landmarks=2048) for k in keys]
    obs = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[observe_sequence(rig, sc, K, k, pixel_noise=0.2, desc_flip_prob=0.01)
          for sc, k in zip(scenes, keys)],
    )
    states = init_batched_ba_states(
        S, cfg, jax.random.PRNGKey(1),
        T0=jnp.stack([sc.poses[0] for sc in scenes]),
    )
    return rig, cfg, scenes, obs, states


def test_batched_ba_equals_sequential_ba():
    """Batched windowed-BA replay (B:10's full contract) == per-sequence
    step_ba replay, keyframe schedule and map state included."""
    from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba
    from sosvo.vo.batched import run_replay_ba_batched

    rig, cfg, scenes, obs, states = _ba_problem()
    _, outs_b = jax.jit(lambda s, o: run_replay_ba_batched(rig, cfg, s, o))(
        states, obs)
    assert bool(jnp.all(outs_b.vo.pose_ok[:, 1:]))
    # The batched run actually exercised BA: keyframes exist and at least one
    # window solve produced a nonzero cost on some sequence.
    assert int(jnp.sum(outs_b.is_keyframe.astype(jnp.int32))) == S * ((F + 2) // 3)
    assert bool(jnp.any(outs_b.ba_cost > 0))
    for i in range(S):
        st = jax.tree.map(lambda x: x[i], states)
        ob = jax.tree.map(lambda x: x[i], obs)
        _, outs_1 = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))(st, ob)
        assert float(jnp.max(jnp.abs(outs_b.vo.T_world[i] - outs_1.vo.T_world))) < 1e-4
        rmse, _ = ate_rmse(outs_b.vo.T_world[i, 1:, :3, 3],
                           scenes[i].poses[1:, :3, 3])
        assert float(rmse) < 0.05


def test_batched_ba_data_sharded(devices8):
    """Batched BA replay under "data"-axis sharding == unsharded."""
    from sosvo.vo.batched import run_replay_ba_batched

    rig, cfg, scenes, obs, states = _ba_problem()
    mesh = data_mesh(4)
    states_s, obs_s = shard_batched_inputs(mesh, states, obs)
    f = jax.jit(lambda s, o: run_replay_ba_batched(rig, cfg, s, o))
    _, outs_u = f(states, obs)
    _, outs_s = f(states_s, obs_s)
    assert float(jnp.max(jnp.abs(outs_u.vo.T_world - outs_s.vo.T_world))) < 1e-5
