"""Replay driver CLI: run a benchmark config end-to-end.

Usage:
    python -m sosvo.cli --config configs/c1_cpu_smoke.json --out runs/run1
    python -m sosvo.cli --config ... --ckpt-every 8 --fault-inject 17
    python -m sosvo.cli --config ... --resume         # continue after a kill

Replaces the reference's driver scripts (SURVEY.md C15/SS3.1) with a config-
driven harness: builds the synthetic world, replays the jitted pipeline in
CHUNKS (checkpointing the full tracking pytree between chunks -- SURVEY.md
section 5.3/5.4), logs per-frame JSONL, reports ATE/RPE + frames/s.
`--fault-inject N` kills the process after frame N to prove resume
correctness (the resumed trajectory must equal the uninterrupted one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", default="runs/sosvo_run")
    ap.add_argument("--ckpt-every", type=int, default=16, help="frames per chunk/checkpoint")
    ap.add_argument("--fault-inject", type=int, default=-1,
                    help="kill the process after this frame (tests resume)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mode", choices=["f2f", "ba"], default="ba",
                    help="frame-to-frame only, or keyframed windowed-BA VO")
    ap.add_argument("--source", choices=["obs", "images"], default=None,
                    help="feature observations (c1) or rendered raw omni "
                         "images through the full frontend (c2); defaults to "
                         "the config's pipeline.mode")
    ap.add_argument("--pgo", action="store_true",
                    help="pose-graph loop closing at the end (or set "
                         "pipeline.pose_graph in the config, as c3 does)")
    ap.add_argument("--platform", default=None, help="override jax platform (e.g. cpu)")
    ap.add_argument("--sequence", default=None,
                    help="replay a STAGED capture (.npz from "
                         "scripts/stage_sequence.py: real image files + "
                         "optional TUM ground truth) instead of the synthetic "
                         "world; implies --source images")
    ap.add_argument("--rig", default=None,
                    help="rig calibration JSON (sosvo.sensor.calib_io) for "
                         "--sequence; default: the built-in rig at the "
                         "sequence's image size")
    ap.add_argument("--verify-sharded", action="store_true",
                    help="with dist.model_parallel > 1 or dist.data_parallel "
                         "> 1: also run the single-device replay and record "
                         "the sharded-vs-single trajectory difference in "
                         "report.json")
    ap.add_argument("--viz", action="store_true",
                    help="write visualization artifacts to --out: trajectory "
                         "plot, 3D landmark map + PLY point cloud (ba mode), "
                         "keypoint/stereo-match overlays (image mode)")
    args = ap.parse_args(argv)

    import jax

    from sosvo.utils.runtime import setup_compilation_cache

    setup_compilation_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp

    from sosvo.eval.ate import ate_rmse, rpe
    from sosvo.sensor.rig import default_rig
    from sosvo.synth.scene import make_scene, observe_sequence
    from sosvo.utils.checkpoint import latest_step, restore_state, save_state
    from sosvo.utils.config import load_pipeline_config
    from sosvo.utils.framelog import stepoutput_rows, write_jsonl
    from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba
    from sosvo.vo.loop_closure import pgo_refine_trajectory
    from sosvo.vo.pipeline import run_replay
    from sosvo.vo.state import init_track_state

    with open(args.config) as f:
        raw = json.load(f)
    run = raw.get("run", {})
    cfg = load_pipeline_config(args.config)
    n_frames = int(run.get("n_frames", 10))
    n_landmarks = int(run.get("n_landmarks", 4096))
    pixel_noise = float(run.get("pixel_noise", 0.3))
    desc_flip = float(run.get("desc_flip_prob", 0.02))
    K = cfg.frontend.max_features

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ckpt_dir = out / "ckpt"
    log_path = out / "frames.jsonl"

    extract_wall = None  # set by the rendered-images branch below
    source = "images" if args.sequence else (
        args.source or ("images" if cfg.mode == "images" else "obs"))
    rig = default_rig()
    scene = make_scene(jax.random.PRNGKey(0), n_frames=n_frames, n_landmarks=n_landmarks)
    gt_available = True
    if cfg.dist.data_parallel > 1:
        obs = None  # built per-sequence in the batched branch below
    elif args.sequence:
        # Staged real capture: image files -> scripts/stage_sequence.py ->
        # .npz bundle -> full frontend (SURVEY.md C17 real-rig ingestion).
        from sosvo.data.sequence import load_sequence
        from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations

        seq = load_sequence(args.sequence)
        assert seq.images is not None, f"{args.sequence} has no image frames"
        n_frames = int(seq.images.shape[0])
        assert seq.images.shape[1] == seq.images.shape[2], "omni frames must be square"
        if args.rig:
            from sosvo.sensor.calib_io import load_rig
            rig = load_rig(args.rig)
        else:
            rig = default_rig(image_size=int(seq.images.shape[1]))
        gt_available = seq.poses is not None
        if gt_available:
            scene = scene._replace(poses=jnp.asarray(seq.poses))
        else:
            scene = scene._replace(poses=jnp.tile(
                jnp.eye(4, dtype=jnp.float32), (n_frames, 1, 1)))
        imgs = jnp.asarray(seq.images)
        img0 = np.asarray(imgs[0])  # kept for the --viz overlays
        luts = build_frontend_luts(rig, cfg.frontend)
        extract = jax.jit(jax.vmap(lambda im: extract_observations(rig, luts, cfg.frontend, im)))
        obs = extract(imgs)
    elif source == "images":
        # Full frontend path (config c2): ray-cast the analytic room through
        # the exact sensor model, then detect/describe/match from pixels.
        from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
        from sosvo.synth.render import RoomScene, render_sequence
        from sosvo.synth.scene import make_trajectory

        room = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
        poses = make_trajectory(n_frames, radius=0.4)
        scene = scene._replace(poses=poses)
        luts = build_frontend_luts(rig, cfg.frontend)
        t_extract0 = time.perf_counter()
        # Render + extract in chunks: at c3_long scale (1024 frames) the
        # whole-sequence image stack is ~2.3 GB and a vmapped extract would
        # materialize per-frame frontend intermediates for EVERY frame at
        # once; chunking bounds peak memory at chunk x (image + frontend)
        # while the kept observations are ~150 KB/frame. lax.map inside the
        # chunk keeps extraction sequential on-device (the c2-measured
        # fastest layout).
        chunk_r = min(int(run.get("render_chunk", 64)), n_frames)
        render_extract = jax.jit(lambda P: jax.lax.map(
            lambda im: extract_observations(rig, luts, cfg.frontend, im),
            render_sequence(rig, P, room)))
        # Pad the tail chunk (repeat last pose) so every dispatch shares one
        # compiled shape; padded frames are sliced off below.
        n_pad = (-n_frames) % chunk_r
        poses_p = jnp.concatenate([poses, jnp.tile(poses[-1:], (n_pad, 1, 1))]) \
            if n_pad else poses
        obs_chunks = [render_extract(poses_p[f0:f0 + chunk_r])
                      for f0 in range(0, n_frames + n_pad, chunk_r)]
        obs = jax.tree.map(
            lambda *xs: jnp.concatenate(xs)[:n_frames], *obs_chunks)
        jax.block_until_ready(obs)
        extract_wall = time.perf_counter() - t_extract0
        if args.viz:
            # The chunked pipeline discards the rendered frames (that is the
            # point -- peak memory); re-render frame 0 for the overlays.
            img0 = np.asarray(jax.jit(lambda P: render_sequence(rig, P, room))(
                poses[:1])[0])
    else:
        obs = observe_sequence(rig, scene, K, jax.random.PRNGKey(1),
                               pixel_noise=pixel_noise, desc_flip_prob=desc_flip)

    # --- distributed execution (SURVEY.md P1-DP / P2-TP; configs c4/c5) ---
    # data_parallel > 1: S independent sequences batched on the "data" mesh
    # axis (c4). model_parallel > 1: every keyframe BA solve landmark-sharded
    # over the "model" axis inside the replay scan (c5). Either mesh clamps
    # to the visible device count (use
    # XLA_FLAGS=--xla_force_host_platform_device_count=8 --platform cpu for
    # a virtual mesh, SURVEY.md section 4.3).
    n_dev = len(jax.devices())
    dp = min(cfg.dist.data_parallel, n_dev)
    mp = min(cfg.dist.model_parallel, n_dev)
    batched = cfg.dist.data_parallel > 1
    S = int(run.get("n_sequences", cfg.dist.data_parallel)) if batched else 1
    while batched and S % dp != 0:
        dp -= 1  # mesh axis must divide the sequence count

    if batched:
        # c4: S sequences in lockstep (f2f or windowed-BA pipeline),
        # sequence axis sharded.
        from sosvo.dist.mesh import data_mesh
        from sosvo.vo.batched import (run_replay_ba_batched,
                                      run_replay_batched,
                                      shard_batched_inputs,
                                      synthetic_batched_inputs)

        assert source == "obs", "batched replay is observation-mode (c4)"
        state0, obs, gt_poses = synthetic_batched_inputs(
            rig, cfg, S, n_frames, n_landmarks, pixel_noise=pixel_noise,
            desc_flip_prob=desc_flip, ba=args.mode == "ba")
        mesh = data_mesh(dp)
        if args.mode == "ba":
            # Batched windowed-BA replay (B:10's full contract: the batched
            # path runs the shared Schur/BA kernels, not just the f2f step).
            if cfg.keyframe_mode == "adaptive":
                print("WARNING: batched BA replay forces the lockstep stride "
                      "keyframe schedule; keyframe_mode='adaptive' is ignored "
                      "in this mode (per-lane adaptive cadence would desync "
                      "the vmapped window solve).", file=sys.stderr)
            replay = jax.jit(lambda s, o: run_replay_ba_batched(rig, cfg, s, o))
            get_T = lambda o: o.vo.T_world                # (S, F, 4, 4)
            get_vo = lambda o: jax.tree.map(lambda x: x[0], o.vo)
        else:
            replay = jax.jit(lambda s, o: run_replay_batched(rig, cfg, s, o))
            get_T = lambda o: o.T_world                   # (S, F, 4, 4)
            get_vo = lambda o: jax.tree.map(lambda x: x[0], o)  # log sequence 0
        unsharded = (state0, obs)  # single-device inputs for --verify-sharded
        state0, obs = shard_batched_inputs(mesh, state0, obs)
        get_kf = None  # PGO (the keyframe-flag consumer) is non-batched only
        slice_obs = lambda f, hi: jax.tree.map(lambda x: x[:, f:hi], obs)
    else:
        gt_poses = scene.poses
        slice_obs = lambda f, hi: jax.tree.map(lambda x: x[f:hi], obs)
        if args.mode == "ba":
            state0 = init_ba_state(cfg, jax.random.PRNGKey(2), T0=scene.poses[0])
            if cfg.dist.model_parallel > 1:
                from sosvo.dist.mesh import model_mesh
                from sosvo.dist.replay_dist import run_replay_ba_sharded

                while cfg.ba.max_landmarks % mp != 0:
                    mp -= 1  # model axis must divide the landmark capacity
                mesh = model_mesh(mp)
                replay = jax.jit(
                    lambda s, o: run_replay_ba_sharded(mesh, rig, cfg, s, o))
            else:
                replay = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))
            get_T = lambda o: o.vo.T_world
            get_vo = lambda o: o.vo
            get_kf = lambda o: o.is_keyframe
        else:
            state0 = init_track_state(K, jax.random.PRNGKey(2), T0=scene.poses[0])
            replay = jax.jit(lambda s, o: run_replay(rig, cfg, s, o))
            get_T = lambda o: o.T_world
            get_vo = lambda o: o
            get_kf = None

    fax = 1 if batched else 0  # the frame axis of stacked trajectories
    start_frame = 0
    state = state0
    traj_prefix = np.zeros((S, 0, 4, 4) if batched else (0, 4, 4), np.float32)
    kf_prefix = np.zeros((0,), bool)
    if args.resume:
        step = latest_step(ckpt_dir)
        if step is not None:
            state = restore_state(ckpt_dir, step, state0)
            start_frame = step
            # The ESTIMATED trajectory up to the checkpoint, saved alongside
            # the state pytree -- never the scene's ground-truth poses, which
            # must not leak into any estimation path (PGO below consumes the
            # full estimated trajectory).
            traj_prefix = np.load(ckpt_dir / f"traj_{step:08d}.npy")
            kf_path = ckpt_dir / f"kf_{step:08d}.npy"
            if kf_path.exists():  # keyframe flags (ba mode): the PGO stage
                kf_prefix = np.load(kf_path)  # needs the scan's ACTUAL set
            print(f"[sosvo] resumed from checkpoint at frame {step}")

    chunk = max(1, args.ckpt_every)
    all_T = [traj_prefix]
    all_kf = [kf_prefix]
    t0 = time.perf_counter()
    f = start_frame
    append = args.resume and start_frame > 0
    while f < n_frames:
        hi = min(f + chunk, n_frames)
        state, outs = jax.block_until_ready(replay(state, slice_obs(f, hi)))
        vo = get_vo(outs)
        all_T.append(np.asarray(get_T(outs)))
        if get_kf is not None and not batched:
            all_kf.append(np.asarray(get_kf(outs)))
        write_jsonl(log_path, stepoutput_rows(vo, t_offset=f), append=append)
        append = True
        save_state(ckpt_dir, hi, state)
        np.save(ckpt_dir / f"traj_{hi:08d}.npy", np.concatenate(all_T, axis=fax))
        if get_kf is not None and not batched:
            np.save(ckpt_dir / f"kf_{hi:08d}.npy", np.concatenate(all_kf))
        if 0 <= args.fault_inject < hi:
            print(f"[sosvo] fault injection: dying after frame {hi}")
            sys.stdout.flush()
            import os as _os
            _os._exit(42)
        f = hi
    wall = time.perf_counter() - t0

    # Full ESTIMATED trajectory (checkpointed prefix + this run's frames):
    # identical to the uninterrupted run's by the resume-exactness guarantee,
    # so every downstream consumer (PGO, ATE) behaves as if never interrupted.
    T_est = jnp.asarray(np.concatenate(all_T, axis=fax))
    T_vo = T_est  # pre-PGO trajectory (the sharded-vs-single comparison point)
    gt = gt_poses
    n_loops = 0
    pgo_wall = None
    t_pgo0 = time.perf_counter()
    if (args.pgo or cfg.pose_graph) and not batched:
        pgo_kwargs = dict(
            min_inliers=cfg.loop_min_inliers,
            max_candidates=cfg.loop_candidates or None,
            robust=cfg.pgo_robust, robust_delta=cfg.pgo_robust_delta)
        if args.mode == "ba":
            # Hand PGO the scan's ACTUAL keyframe set so it optimizes the
            # same nodes the BA window used (identical to the stride set in
            # "stride" mode; the whole point in "adaptive" mode). The flags
            # must cover EVERY frame: resuming from a checkpoint written
            # before kf_*.npy existed leaves a prefix gap, and nonzero()
            # over a short array would hand PGO indices shifted by
            # start_frame -- silently the wrong node set. Fall back to the
            # stride schedule in that case.
            kf_flags = np.concatenate(all_kf)
            kf_idx_scan = np.nonzero(kf_flags)[0]
            if len(kf_flags) == n_frames and len(kf_idx_scan) >= 2:
                pgo_kwargs["kf_idx"] = kf_idx_scan
        if cfg.dist.pgo_shards > 1:
            # Long-trajectory mode (SURVEY.md section 5.7): candidate pairs
            # sharded for detection, keyframe nodes time-sharded for the PGO
            # solve -- one mesh end to end (sosvo/dist/c3_dist.py). Clamps to
            # the visible device count (a 1-device mesh still runs the
            # sharded program).
            from sosvo.dist.c3_dist import pgo_refine_trajectory_sharded
            from sosvo.dist.mesh import data_mesh

            shards = min(cfg.dist.pgo_shards, n_dev)
            T_est, n_loops = pgo_refine_trajectory_sharded(
                data_mesh(shards), rig, cfg, obs, T_est, **pgo_kwargs)
        else:
            T_est, n_loops = pgo_refine_trajectory(rig, cfg, obs, T_est,
                                                   **pgo_kwargs)
        n_loops = int(n_loops)
        jax.block_until_ready(T_est)
        pgo_wall = time.perf_counter() - t_pgo0

    if batched:
        ates = [float(ate_rmse(T_est[s, 1:, :3, 3], gt[s, 1:, :3, 3])[0])
                for s in range(S)]
        rmse = float(np.sqrt(np.mean(np.square(ates))))
        t_rpe = r_rpe = jnp.float32(0.0)
        T_est0, gt0 = T_est[0], gt[0]
        if n_frames > 2:
            t_rpe, r_rpe = rpe(T_est0[1:], gt0[1:])
    elif not gt_available:
        # Staged capture without ground truth: no ATE/RPE to report.
        rmse = t_rpe = r_rpe = float("nan")
    else:
        rmse, _ = ate_rmse(T_est[1:, :3, 3], gt[1:, :3, 3])
        if T_est.shape[0] > 2:
            t_rpe, r_rpe = rpe(T_est[1:], gt[1:])
        else:  # a 2-frame run is a single pose pair; RPE needs >= 2
            t_rpe = r_rpe = jnp.float32(0.0)
    done = n_frames - start_frame

    def _round(x):
        return None if np.isnan(float(x)) else round(float(x), 6)

    report = {
        "config": args.config,
        "frames": done,
        "ate_rmse_m": _round(rmse),
        "rpe_t_m": _round(t_rpe),
        "rpe_r_rad": _round(r_rpe),
        "frames_per_s": round(done * (S if batched else 1) / wall, 2),
        "wall_s": round(wall, 2),
        "mode": ("batched-ba" if args.mode == "ba" else "batched-f2f")
        if batched else args.mode,
        "pgo_loops": n_loops,
        "device": str(jax.devices()[0]),
    }
    if n_loops and not batched and gt_available:
        # VO-only vs PGO-refined: the loop-closure benefit in one artifact.
        rmse_vo, _ = ate_rmse(T_vo[1:, :3, 3], gt[1:, :3, 3])
        report["ate_rmse_vo_m"] = _round(rmse_vo)
        report["pgo_wall_s"] = round(pgo_wall, 2)
    if extract_wall is not None:
        report["extract_wall_s"] = round(extract_wall, 2)
    if batched:
        report["n_sequences"] = S
        report["mesh"] = {"data": dp}
        report["ate_per_sequence"] = [round(a, 6) for a in ates]
        if args.verify_sharded:
            # Two one-device replays of the same inputs. All S sequences
            # batched on one device: a coupling across the sequence axis
            # would show here, but XLA may compile batch S and batch S/dp
            # into kernels that round differently, so this agrees only to a
            # tolerance (scripts/batch_drift.py measures it). Each device's
            # share alone: the same batch size as the sharded program, so it
            # must agree to the last bit.
            def one_device(lo, hi):
                return get_T(jax.block_until_ready(replay(*jax.tree.map(
                    lambda x: x[lo:hi], unsharded)))[1])

            per = S // dp
            T_all = one_device(0, S)
            T_share = T_all if per == S else jnp.concatenate(
                [one_device(i, i + per) for i in range(0, S, per)])
            report["sharded_vs_single_max_pose_diff"] = float(
                jnp.max(jnp.abs(T_vo - T_all)))
            report["sharded_vs_per_device_share_max_pose_diff"] = float(
                jnp.max(jnp.abs(T_vo - T_share)))
    if not batched and cfg.dist.model_parallel > 1 and args.mode == "ba":
        report["mesh"] = {"model": mp}
        if args.verify_sharded:
            # Single-device replay of the identical inputs: the sharded
            # (psum-reduced) solves must reproduce it to f32 tolerance.
            _, outs_1 = jax.block_until_ready(jax.jit(
                lambda s, o: run_replay_ba(rig, cfg, s, o))(state0, obs))
            diff = float(jnp.max(jnp.abs(T_vo - outs_1.vo.T_world)))
            rmse_1, _ = ate_rmse(outs_1.vo.T_world[1:, :3, 3], gt[1:, :3, 3])
            report["sharded_vs_single_max_pose_diff"] = diff
            report["ate_rmse_single_device"] = round(float(rmse_1), 6)
    (out / "report.json").write_text(json.dumps(report, indent=2))

    if args.viz:
        from sosvo.eval.plots import plot_trajectories
        from sosvo.eval.viz import (keypoint_overlay, match_overlay, plot_map_3d,
                                    save_ply)

        T_plot = T_est[0] if batched else T_est
        gt_plot = gt[0] if batched else gt
        plot_trajectories(np.asarray(T_plot), np.asarray(gt_plot),
                          out / "trajectory.png",
                          title=f"{Path(args.config).stem}: ATE {float(rmse):.4f} m")
        artifacts = ["trajectory.png"]
        # Interactive single-file 3D viewer (SURVEY.md C19: the reference
        # inspected trajectories/maps interactively; headless equivalent).
        from sosvo.eval.html_viewer import export_html_viewer

        export_html_viewer(
            out / "viewer.html", np.asarray(T_plot),
            traj_gt=np.asarray(gt_plot) if gt_available else None,
            landmarks=(np.asarray(state.map.lm_pos)
                       if args.mode == "ba" and not batched else None),
            lm_valid=(np.asarray(state.map.lm_valid)
                      if args.mode == "ba" and not batched else None),
            ate=None if np.isnan(float(rmse)) else float(rmse),
            title=Path(args.config).stem)
        artifacts += ["viewer.html"]
        if args.mode == "ba" and not batched:
            lm = np.asarray(state.map.lm_pos)
            lv = np.asarray(state.map.lm_valid)
            n_pts = save_ply(out / "map.ply", lm, valid=lv)
            plot_map_3d(out / "map_3d.png", np.asarray(T_est), lm, lv,
                        traj_gt=np.asarray(gt),
                        title=f"landmark map ({n_pts} points)")
            artifacts += ["map.ply", "map_3d.png"]
        if source == "images":
            from sosvo.vo.pipeline import _match, azimuth_of

            o0 = jax.tree.map(lambda x: x[0], obs)
            keypoint_overlay(out / "keypoints.png", img0,
                             np.asarray(o0.uv_top), np.asarray(o0.valid_top),
                             np.asarray(o0.uv_bottom), np.asarray(o0.valid_bottom))
            m = _match(cfg, o0.desc_top, o0.desc_bottom, o0.valid_top,
                       o0.valid_bottom, az_a=azimuth_of(o0.ray_top),
                       az_b=azimuth_of(o0.ray_bottom),
                       band=cfg.frontend.stereo_band_rad)
            match_overlay(out / "matches.png", img0,
                          np.asarray(o0.uv_top),
                          np.asarray(o0.uv_bottom[m.idx_b]), np.asarray(m.valid))
            artifacts += ["keypoints.png", "matches.png"]
        print(f"[sosvo] viz artifacts: {', '.join(artifacts)}")

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
