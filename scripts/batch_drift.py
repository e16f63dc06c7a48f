#!/usr/bin/env python
"""How far the batched replay moves with its batch size, on one device.

Replays S synthetic sequences batched on one device (the c4 path), then
each sequence alone at batch 1, and prints the largest pose difference
between the two for each seed. The lanes of the batched replay are
independent by construction, so a difference comes from kernels that XLA
compiles differently for batch S and batch 1, amplified over the frames
by RANSAC's inlier decisions; a reduction or a shared random key across
the sequence axis would show as a difference too.

    python scripts/batch_drift.py --config configs/c4_batched_replay.json \\
        --seeds 0 1 2                       # seed 0: c4's own inputs
    python scripts/batch_drift.py --config ... --platform cpu

Prints one JSON line: the device, and per seed the max pose difference,
that of the batched replay run twice, and each sequence's ATE in both runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--mode", choices=["f2f", "ba"], default="ba")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    import jax

    from sosvo.utils.runtime import setup_compilation_cache

    setup_compilation_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from sosvo.eval.ate import ate_rmse
    from sosvo.sensor.rig import default_rig
    from sosvo.utils.config import load_pipeline_config
    from sosvo.vo.batched import (run_replay_ba_batched, run_replay_batched,
                                  synthetic_batched_inputs)

    run = json.loads(Path(args.config).read_text()).get("run", {})
    cfg = load_pipeline_config(args.config)
    S = int(run.get("n_sequences", cfg.dist.data_parallel))
    rig = default_rig()
    ba = args.mode == "ba"
    fn = run_replay_ba_batched if ba else run_replay_batched
    replay = jax.jit(lambda s, o: fn(rig, cfg, s, o))

    def T_of(s, o):
        outs = jax.block_until_ready(replay(s, o))[1]
        return (outs.vo if ba else outs).T_world       # (S', F, 4, 4)

    def ates(T, gt):
        return [float(ate_rmse(T[i, 1:, :3, 3], gt[i, 1:, :3, 3])[0])
                for i in range(T.shape[0])]

    dev = jax.devices()[0]
    res = {"device": {"platform": dev.platform, "kind": dev.device_kind},
           "config": args.config, "mode": args.mode, "n_sequences": S,
           "seeds": {}}
    for seed in args.seeds:
        state0, obs, gt = synthetic_batched_inputs(
            rig, cfg, S, int(run.get("n_frames", 10)),
            int(run.get("n_landmarks", 4096)),
            pixel_noise=float(run.get("pixel_noise", 0.3)),
            desc_flip_prob=float(run.get("desc_flip_prob", 0.02)),
            ba=ba, seed=seed)
        T_b = T_of(state0, obs)
        T_1 = jnp.concatenate([
            T_of(*jax.tree.map(lambda x: x[i:i + 1], (state0, obs)))
            for i in range(S)])
        res["seeds"][seed] = {
            "max_pose_diff": float(jnp.max(jnp.abs(T_b - T_1))),
            # The same batched program once more: nonzero means the device
            # does not repeat itself, whatever the batch size.
            "rerun_max_pose_diff": float(
                jnp.max(jnp.abs(T_b - T_of(state0, obs)))),
            "max_pose_diff_per_sequence": [
                float(jnp.max(jnp.abs(T_b[i] - T_1[i]))) for i in range(S)],
            "ate_batched_m": ates(T_b, gt), "ate_alone_m": ates(T_1, gt)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
