"""Landmark-sharded replay (config c5 composition): the scan with shard_map'd
keyframe BA solves must reproduce the single-device replay's trajectory."""

import jax
import jax.numpy as jnp

from sosvo.dist.mesh import model_mesh
from sosvo.dist.replay_dist import run_replay_ba_sharded
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_sequence
from sosvo.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba

F, K, L = 10, 128, 256


def test_sharded_replay_matches_single_device():
    rig = default_rig()
    cfg = PipelineConfig(
        frontend=FrontendConfig(max_features=K),
        ransac=RansacConfig(n_hyps=128),
        ba=BAConfig(window=3, max_landmarks=L, iters=3),
        keyframe_every=3,
    )
    scene = make_scene(jax.random.PRNGKey(0), n_frames=F, n_landmarks=2048)
    obs = observe_sequence(rig, scene, K, jax.random.PRNGKey(1),
                           pixel_noise=0.3, desc_flip_prob=0.02)
    s0 = init_ba_state(cfg, jax.random.PRNGKey(2), T0=scene.poses[0])

    _, outs_1 = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))(s0, obs)

    mesh = model_mesh(len(jax.devices()))
    _, outs_n = jax.jit(
        lambda s, o: run_replay_ba_sharded(mesh, rig, cfg, s, o))(s0, obs)

    # Same windows in -> same solves out (up to psum reduction-order f32
    # noise, which compounds through the scan but stays tiny here).
    diff = float(jnp.max(jnp.abs(outs_n.vo.T_world - outs_1.vo.T_world)))
    assert diff < 1e-3, f"sharded replay diverged from single-device: {diff}"
    assert bool(jnp.any(outs_n.is_keyframe))
    assert float(jnp.max(outs_n.ba_cost)) > 0.0  # BA actually ran
