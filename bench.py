#!/usr/bin/env python
"""Benchmark harness: end-to-end c1 VO replay throughput on one GPU.

Prints the card (`device_kind`, and `nvidia-smi`'s name and power limit),
then ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
"device": {...}}. With no GPU it exits non-zero; it never measures the CPU.

Protocol (BASELINE.md): benchmark config c1 workload (10-frame synthetic
sequence, 512 feature slots, full jitted pipeline: stereo match -> triangulate
-> temporal match -> vmapped RANSAC (rigid; essential cross-check on
questionable frames, utils/config.py:lazy_essential_gate) -> bearing refine),
replayed via lax.scan. One warm-up call (compile excluded), then the median of
the timed replays, each ending in `block_until_ready`. `vs_baseline` is
value / 30 frames/s -- the reference runs "near-real-time" on CPU per its
papers (SURVEY.md section 6; no exact published number is retrievable in this
environment, see BASELINE.md), so 30 fps is the provisional reference-parity
anchor.
"""

import json
import statistics
import sys
import time

N_FRAMES = 10
K = 512
N_TIMED = 20
BASELINE_FPS = 30.0  # provisional anchor: reference's "near-real-time" CPU rate


def c1_inputs():
    """The c1 replay: rig, config, initial state, observations, scene."""
    import jax

    from sosvo.sensor.rig import default_rig
    from sosvo.synth.scene import make_scene, observe_sequence
    from sosvo.utils.config import PipelineConfig
    from sosvo.vo.state import init_track_state

    rig = default_rig()
    scene = make_scene(jax.random.PRNGKey(0), n_frames=N_FRAMES, n_landmarks=4096)
    obs = observe_sequence(rig, scene, K, jax.random.PRNGKey(1),
                           pixel_noise=0.3, desc_flip_prob=0.02)
    state = init_track_state(K, jax.random.PRNGKey(2), T0=scene.poses[0])
    return rig, PipelineConfig(), state, obs, scene


def main() -> int:
    from sosvo.utils.runtime import (NoGPUError, gpu_name_and_power_limit,
                                     require_gpu, setup_compilation_cache)

    gpu = gpu_name_and_power_limit()  # before JAX opens the card
    import jax

    setup_compilation_cache()
    try:
        require_gpu(jax.devices())
    except NoGPUError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind} x{len(jax.devices())}; nvidia-smi: {gpu}")

    from sosvo.eval.ate import ate_rmse
    from sosvo.vo.pipeline import run_replay

    rig, cfg, state, obs, scene = c1_inputs()
    replay = jax.jit(lambda s, o: run_replay(rig, cfg, s, o))
    _, outs = jax.block_until_ready(replay(state, obs))  # warm-up/compile

    times = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        jax.block_until_ready(replay(state, obs))
        times.append(time.perf_counter() - t0)
    fps = N_FRAMES / statistics.median(times)

    # Sanity gate: the benchmark only counts if the pipeline actually tracks.
    rmse, _ = ate_rmse(outs.T_world[1:, :3, 3], scene.poses[1:, :3, 3])
    if not float(rmse) < 0.08:
        print(f"bench.py: pipeline lost track: ATE={float(rmse)}", file=sys.stderr)
        return 1

    print(json.dumps({
        "metric": "vo_frames_per_s_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
