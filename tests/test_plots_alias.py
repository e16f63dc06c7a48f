"""Smoke tests: plot outputs render to files (C19); alias package surface."""

import numpy as np


def test_plot_trajectories_writes_png(tmp_path):
    from sosvo.eval.plots import plot_frame_stats, plot_trajectories
    from sosvo.synth.scene import make_trajectory

    poses = np.asarray(make_trajectory(10))
    p1 = tmp_path / "traj.png"
    plot_trajectories(poses, poses, p1)
    assert p1.stat().st_size > 1000

    rows = [{"frame": i, "n_stereo": 100, "n_temporal": 80, "n_inliers": 60,
             "pose_ok": True, "pos": [0, 0, 0]} for i in range(10)]
    p2 = tmp_path / "stats.png"
    plot_frame_stats(rows, p2)
    assert p2.stat().st_size > 1000


def test_alias_package_surface():
    import vo_single_camera_sos_tpu as vst

    assert vst.__version__
    # The alias exposes every subsystem of the canonical package.
    for sub in ("backend", "frontend", "geometry", "sensor",
                "vo", "dist", "synth", "eval", "utils", "data", "calib"):
        assert hasattr(vst, sub), sub
