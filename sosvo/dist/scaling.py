"""Scaling-efficiency measurement harness (BASELINE.json:5: report frames/s
at 1 chip / 1 host / N hosts; target >= 80% efficiency 1 chip -> slice).

Measures end-to-end batched-replay throughput (sequences sharded on the
"data" axis) at device counts [1, 2, ..., N] on whatever backend is live --
the cards of one host when available, the virtual CPU mesh otherwise (the
mechanism is identical; CPU-mesh numbers validate the sharding, not
interconnect bandwidth, and are labeled as such in the report).

Run:  python -m sosvo.dist.scaling [--devices 8] [--frames 16] [--seqs-per-dev 2]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def measure_scaling(device_counts=None, n_frames: int = 16, k: int = 256,
                    seqs_per_device: int = 2, n_landmarks: int = 2048) -> dict:
    import os

    import jax

    # A multi-device run requested via --xla_force_host_platform_device_count
    # must land on the CPU backend even where a GPU is present (as in
    # __graft_entry__.dryrun_multichip).
    if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from sosvo.dist.mesh import data_mesh
    from sosvo.sensor.rig import default_rig
    from sosvo.synth.scene import make_scene, observe_sequence
    from sosvo.utils.config import FrontendConfig, PipelineConfig
    from sosvo.utils.profiling import time_jitted
    from sosvo.vo.batched import init_batched_states, run_replay_batched, shard_batched_inputs

    devs = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]

    rig = default_rig()
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=k))
    rows = []
    base_fps_per_dev = None
    for nd in device_counts:
        S = seqs_per_device * nd
        keys = jax.random.split(jax.random.PRNGKey(0), S)
        scenes = [make_scene(kk, n_frames=n_frames, n_landmarks=n_landmarks) for kk in keys]
        obs = jax.tree.map(
            lambda *xs: jnp.stack(xs),
            *[observe_sequence(rig, sc, k, kk, pixel_noise=0.3, desc_flip_prob=0.02)
              for sc, kk in zip(scenes, keys)],
        )
        states = init_batched_states(S, k, jax.random.PRNGKey(1),
                                     T0=jnp.stack([sc.poses[0] for sc in scenes]))
        mesh = data_mesh(nd, devices=devs[:nd])
        states, obs = shard_batched_inputs(mesh, states, obs)
        fn = jax.jit(lambda s, o: run_replay_batched(rig, cfg, s, o))
        t = time_jitted(fn, states, obs, n=5)
        fps = S * n_frames / t
        fps_per_dev = fps / nd
        if base_fps_per_dev is None:
            base_fps_per_dev = fps_per_dev
        rows.append({
            "devices": nd,
            "sequences": S,
            "frames_per_s": round(fps, 2),
            "frames_per_s_per_device": round(fps_per_dev, 2),
            "scaling_efficiency": round(fps_per_dev / base_fps_per_dev, 3),
        })
    return {
        "backend": str(devs[0].platform),
        "device_kind": str(devs[0].device_kind),
        "note": ("CPU virtual mesh: validates sharding mechanics, not "
                 "interconnect bandwidth" if devs[0].platform == "cpu" else "real devices"),
        "rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--seqs-per-dev", type=int, default=2)
    args = ap.parse_args(argv)
    counts = None if args.devices is None else [n for n in (1, 2, 4, 8, 16, 32)
                                                if n <= args.devices]
    report = measure_scaling(counts, n_frames=args.frames,
                             seqs_per_device=args.seqs_per_dev)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
