"""Motion-adaptive keyframing (SURVEY.md C15 keyframe logic; COMPAT #11).

On a variable-speed trajectory a fixed keyframe stride wastes window slots
while hovering and under-samples fast segments; the adaptive trigger
(translation/rotation thresholds + max-gap) must deliver equal-or-better
ATE from FEWER keyframes."""

import jax
import jax.numpy as jnp

from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, make_trajectory, observe_sequence
from sosvo.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba

F, K = 36, 256


def _variable_speed_scene():
    # First 2/3 hovering (1/10th speed), last 1/3 fast: same path, warped
    # parameter. Per-frame f2f noise is speed-independent, so keyframe/BA
    # corrections matter most through the fast segment -- which is where the
    # adaptive trigger concentrates its budget.
    slow = F * 2 // 3
    speeds = jnp.where(jnp.arange(F) < slow, 0.1, 3.2)
    times = jnp.concatenate([jnp.zeros(1), jnp.cumsum(speeds)[:-1]])
    scene = make_scene(jax.random.PRNGKey(0), n_frames=F, n_landmarks=4096)
    return scene._replace(poses=make_trajectory(F, times=times))


def _run(cfg, scene, obs):
    s0 = init_ba_state(cfg, jax.random.PRNGKey(2), T0=scene.poses[0])
    _, outs = jax.jit(lambda s, o: run_replay_ba(rig_g, cfg, s, o))(s0, obs)
    from sosvo.eval.ate import ate_rmse

    rmse, _ = ate_rmse(outs.vo.T_world[1:, :3, 3], scene.poses[1:, :3, 3])
    return float(rmse), int(jnp.sum(outs.is_keyframe.astype(jnp.int32)))


rig_g = default_rig()


def test_adaptive_fewer_keyframes_equal_or_better_ate():
    scene = _variable_speed_scene()
    obs = observe_sequence(rig_g, scene, K, jax.random.PRNGKey(1),
                           pixel_noise=0.3, desc_flip_prob=0.02)
    base = dict(frontend=FrontendConfig(max_features=K),
                ransac=RansacConfig(n_hyps=256),
                ba=BAConfig(window=4, max_landmarks=512, iters=3))
    cfg_stride = PipelineConfig(**base, keyframe_every=3)
    cfg_adapt = PipelineConfig(**base, keyframe_mode="adaptive",
                               kf_trans_thresh=0.15, kf_rot_thresh=0.15,
                               kf_max_gap=8)

    ate_s, n_s = _run(cfg_stride, scene, obs)
    ate_a, n_a = _run(cfg_adapt, scene, obs)

    # Fewer keyframes (the hover segment collapses to max-gap cadence,
    # the fast segment keyframes nearly every frame: 11 vs 12 measured)...
    assert n_a < n_s, (n_a, n_s)
    # ...at equal-or-better accuracy (measured 0.0089 vs 0.0099; 5% slack
    # for cross-backend f32 jitter).
    assert ate_a <= ate_s * 1.05, (ate_a, ate_s)


def test_adaptive_max_gap_forces_keyframes_when_static():
    # A rig that never moves must still keyframe every kf_max_gap frames.
    scene = make_scene(jax.random.PRNGKey(0), n_frames=F, n_landmarks=4096)
    scene = scene._replace(poses=jnp.tile(scene.poses[:1], (F, 1, 1)))
    obs = observe_sequence(rig_g, scene, K, jax.random.PRNGKey(1),
                           pixel_noise=0.3, desc_flip_prob=0.02)
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=K),
                         ransac=RansacConfig(n_hyps=256),
                         ba=BAConfig(window=4, max_landmarks=512, iters=3),
                         keyframe_mode="adaptive", kf_max_gap=8)
    _, n_kf = _run(cfg, scene, obs)
    expected = 1 + (F - 1) // 8
    assert abs(n_kf - expected) <= 1, (n_kf, expected)


def test_pgo_optimizes_the_scans_adaptive_keyframe_set(monkeypatch):
    """The PGO stage must build its node set from the scan's ACTUAL keyframe
    indices, not a recomputed stride (VERDICT r3 weak #3). Captures the
    PoseGraph handed to pgo_solve and checks node-for-node equality, plus
    that the rigid correction is segment-constant under the adaptive
    governing map."""
    import numpy as np

    from sosvo.vo import loop_closure as lc

    scene = _variable_speed_scene()
    obs = observe_sequence(rig_g, scene, K, jax.random.PRNGKey(1),
                           pixel_noise=0.3, desc_flip_prob=0.02)
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=K),
                         ransac=RansacConfig(n_hyps=256),
                         ba=BAConfig(window=4, max_landmarks=512, iters=3),
                         keyframe_mode="adaptive",
                         kf_trans_thresh=0.15, kf_rot_thresh=0.15,
                         kf_max_gap=8)
    s0 = init_ba_state(cfg, jax.random.PRNGKey(2), T0=scene.poses[0])
    _, outs = jax.jit(lambda s, o: run_replay_ba(rig_g, cfg, s, o))(s0, obs)
    kf_idx = np.nonzero(np.asarray(outs.is_keyframe))[0]
    # Adaptive set is NOT the stride set (else this test proves nothing).
    assert not np.array_equal(kf_idx, lc.keyframe_indices(F, cfg.keyframe_every))

    captured = {}
    real_solve = lc.pgo_solve

    def spy(g, **kw):
        captured["g"] = g
        return real_solve(g, **kw)

    monkeypatch.setattr(lc, "pgo_solve", spy)
    # pgo_refine_trajectory runs as ONE jitted program (r5 -- eager op
    # chains were the measured long-c3 wall); disable jit here so the spy
    # captures concrete arrays instead of tracers.
    with jax.disable_jit():
        T_pgo, _ = lc.pgo_refine_trajectory(
            rig_g, cfg, obs, outs.vo.T_world, min_gap=3, min_inliers=20,
            max_candidates=4, kf_idx=kf_idx)

    g = captured["g"]
    assert g.X.shape[0] == len(kf_idx)
    np.testing.assert_allclose(
        np.asarray(g.X),
        np.asarray(jax.vmap(lambda T: jnp.linalg.inv(T))(outs.vo.T_world[kf_idx])),
        atol=1e-5)

    # Non-keyframe poses move rigidly with their GOVERNING keyframe: within
    # each segment the correction T_new T_old^-1 is constant.
    gov = lc.governing_map(F, kf_idx)
    corr = np.asarray(jnp.einsum(
        "fij,fjk->fik", T_pgo, jax.vmap(lambda T: jnp.linalg.inv(T))(outs.vo.T_world)))
    for k in range(len(kf_idx)):
        seg = corr[gov == k]
        assert np.max(np.abs(seg - seg[0])) < 1e-5


def test_governing_map_matches_stride_for_stride_sets():
    import numpy as np

    from sosvo.vo.loop_closure import governing_map, keyframe_indices

    for n, every in [(1, 4), (7, 3), (20, 4), (33, 5)]:
        kf = keyframe_indices(n, every)
        expected = np.minimum(np.arange(n) // every, len(kf) - 1)
        np.testing.assert_array_equal(governing_map(n, kf), expected)
    # Irregular (adaptive-style) sets: each frame governed by its
    # preceding keyframe.
    kf = np.asarray([0, 2, 3, 9])
    np.testing.assert_array_equal(
        governing_map(12, kf), [0, 0, 1, 2, 2, 2, 2, 2, 2, 3, 3, 3])
