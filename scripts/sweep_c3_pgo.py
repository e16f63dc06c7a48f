#!/usr/bin/env python
"""Why did PGO worsen c3's image-native ATE? Sweep loop-edge settings."""

import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))

import json

import jax
import jax.numpy as jnp

from sosvo.eval.ate import ate_rmse
from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
from sosvo.sensor.rig import default_rig
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory
from sosvo.utils.config import load_pipeline_config
from sosvo.utils.runtime import setup_compilation_cache
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo.vo.loop_closure import pgo_refine_trajectory

F = 200


def main():
    setup_compilation_cache()
    cfg = load_pipeline_config("configs/c3_host_pgo.json")
    rig = default_rig()
    room = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
    poses = make_trajectory(F, radius=0.4)
    imgs = jax.jit(lambda P: render_sequence(rig, P, room))(poses)
    luts = build_frontend_luts(rig, cfg.frontend)
    extract = jax.jit(jax.vmap(lambda im: extract_observations(rig, luts, cfg.frontend, im)))
    obs = extract(imgs)
    state = init_ba_state(cfg, jax.random.PRNGKey(2), T0=poses[0])
    _, outs = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))(state, obs)
    T_vo = outs.vo.T_world
    r_vo, _ = ate_rmse(T_vo[1:, :3, 3], poses[1:, :3, 3])
    print(json.dumps({"setting": "vo-only", "ate": round(float(r_vo), 5)}))

    for tag, kw in [
        ("mi300", dict(min_inliers=300, max_candidates=160)),
        ("mi400", dict(min_inliers=400, max_candidates=160)),
        ("mi600", dict(min_inliers=600, max_candidates=160)),
        ("mi200-c320", dict(min_inliers=200, max_candidates=320)),
        ("mi200-odom3", dict(min_inliers=200, max_candidates=160, odom_weight=3.0)),
    ]:
        T_pgo, n_loops = jax.jit(lambda o, T, kw=kw: pgo_refine_trajectory(
            rig, cfg, o, T, min_gap=3, **kw))(obs, T_vo)
        r, _ = ate_rmse(T_pgo[1:, :3, 3], poses[1:, :3, 3])
        print(json.dumps({"setting": tag, "ate": round(float(r), 5),
                          "loops": int(n_loops)}))


if __name__ == "__main__":
    main()
