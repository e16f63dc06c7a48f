"""Performance-regression floor on the CPU (SURVEY.md section 4.5).

Runs a small c1-style replay on the suite's CPU backend and asserts a
frames/s floor. The floor is deliberately loose (~3x below the rate measured
on a 2-vCPU build host: 182 frames/s at K=256/H=256/8 frames, jax 0.9.0) so
normal host jitter never trips it, while a real regression -- an accidental
f64 promotion, a lost fusion, a per-frame host sync -- still does. Device
rates are measured on the card, not here.
"""

import statistics
import time

import jax
import jax.numpy as jnp

from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_sequence
from sosvo.utils.config import FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo.pipeline import run_replay
from sosvo.vo.state import init_track_state

K, F = 256, 8
CPU_FLOOR = 60.0


def test_replay_throughput_floor():
    rig = default_rig()
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=K),
                         ransac=RansacConfig(n_hyps=256))
    scene = make_scene(jax.random.PRNGKey(0), n_frames=F, n_landmarks=4096)
    obs = observe_sequence(rig, scene, K, jax.random.PRNGKey(1),
                           pixel_noise=0.3, desc_flip_prob=0.02)
    st = init_track_state(K, jax.random.PRNGKey(2), T0=scene.poses[0])
    f = jax.jit(lambda s, o: run_replay(rig, cfg, s, o))
    _, outs = jax.block_until_ready(f(st, obs))  # warm-up / compile
    assert bool(jnp.all(outs.pose_ok[1:])), "replay must track before timing"

    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(f(st, obs))
        ts.append(time.perf_counter() - t0)
    fps = F / statistics.median(ts)

    assert jax.default_backend() == "cpu"
    assert fps > CPU_FLOOR, (
        f"replay throughput regressed: {fps:.1f} frames/s on the CPU "
        f"(floor {CPU_FLOOR}); check for lost fusion / dtype promotion / host syncs")

