"""ORB-parity frontend options: FAST-9 detector, IC_Angle orientation,
steered (rotated) BRIEF. These are the JAX equivalents of the
reference's `cv2.ORB_create` default configuration (SURVEY.md C6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sosvo.frontend.descriptor import describe, orientation
from sosvo.frontend.detect import Keypoints, detect, fast_mask


def _checker_corner(h=48, w=64, r=24, c=32):
    """Image with a single high-contrast corner at (r, c)."""
    img = np.full((h, w), 0.2, np.float32)
    img[:r, :c] = 0.8  # bright quadrant -> corner at its lower-right
    return jnp.asarray(img), r, c


def test_fast_mask_fires_on_corner_not_flat_or_edge():
    img, r, c = _checker_corner()
    m = np.asarray(fast_mask(img, threshold=0.1))
    # Somewhere within 2 px of the corner the segment test fires.
    assert m[r - 2 : r + 3, c - 2 : c + 3].any()
    # Flat regions: no detections.
    assert not m[5:15, 40:60].any()
    # A straight vertical edge far from the corner: FAST-9 needs 9 contiguous
    # ring pixels on one side, a clean step edge gives only 7-8 -> rejected.
    assert not m[30:40, c - 1 : c + 2].any()


def test_detect_fast_ranks_with_harris():
    img, r, c = _checker_corner()
    kps = detect(img, 8, detector="fast", fast_threshold=0.1, border_rows=4)
    assert bool(kps.valid[0])
    # The synthetic quadrant also creates a mirror corner at the azimuth wrap
    # (column 0/w) with an EXACTLY tied Harris response; top-1 order between
    # the two ties is numeric noise, so assert the true corner is in the top 2.
    hits = [i for i in range(2)
            if abs(float(kps.rows[i]) - r) < 3 and abs(float(kps.cols[i]) - c) < 3]
    assert hits, (np.asarray(kps.rows)[:2], np.asarray(kps.cols)[:2])
    # The same call jits (static detector arg).
    jitted = jax.jit(
        lambda im: detect(im, 8, detector="fast", fast_threshold=0.1, border_rows=4)
    )
    kps2 = jitted(img)
    np.testing.assert_allclose(kps.rows, kps2.rows)


def test_detect_unknown_detector_raises():
    img, _, _ = _checker_corner()
    with pytest.raises(ValueError):
        detect(img, 8, detector="sift")


def test_orientation_tracks_gradient_direction():
    # Intensity increasing along +col -> centroid points to +x -> angle ~ 0.
    h, w = 40, 40
    ramp_x = jnp.asarray(np.tile(np.linspace(0, 1, w, dtype=np.float32), (h, 1)))
    kps = Keypoints(
        rows=jnp.array([20.0]), cols=jnp.array([20.0]),
        response=jnp.array([1.0]), valid=jnp.array([True]),
    )
    th = float(orientation(ramp_x, kps)[0])
    assert abs(th) < 0.05
    # Increasing along +row -> angle ~ +pi/2 (y-down convention).
    th2 = float(orientation(ramp_x.T, kps)[0])
    assert abs(th2 - np.pi / 2) < 0.05


def _rotated_texture(angle, h=64, w=64, seed=3):
    """Smooth random texture rendered in a frame rotated by `angle` about
    the image center (so the patch content itself rotates)."""
    rng = np.random.default_rng(seed)
    # Band-limited texture: sum of a few random plane waves (exact under
    # rotation, no resampling artifacts).
    freqs = rng.normal(0, 0.35, (6, 2))
    phases = rng.uniform(0, 2 * np.pi, 6)
    amps = rng.uniform(0.5, 1.0, 6)
    rr, cc = np.mgrid[:h, :w].astype(np.float32)
    yc, xc = rr - h / 2, cc - w / 2
    ca, sa = np.cos(angle), np.sin(angle)
    x = ca * xc - sa * yc
    y = sa * xc + ca * yc
    img = sum(a * np.sin(f[0] * x + f[1] * y + p) for a, f, p in zip(amps, freqs, phases))
    return jnp.asarray(img.astype(np.float32))


def test_steered_brief_is_rotation_invariant():
    kps = Keypoints(
        rows=jnp.array([32.0]), cols=jnp.array([32.0]),
        response=jnp.array([1.0]), valid=jnp.array([True]),
    )
    rot = np.deg2rad(35.0)
    img0, img1 = _rotated_texture(0.0), _rotated_texture(rot)

    def hamming(d0, d1):
        x = np.bitwise_xor(np.asarray(d0), np.asarray(d1))
        return int(sum(bin(int(v)).count("1") for v in x.ravel()))

    # Upright BRIEF: the rotated patch scrambles most comparisons.
    d_up = hamming(describe(img0, kps), describe(img1, kps))
    # Steered BRIEF with the measured IC angles: distance collapses.
    a0 = orientation(img0, kps)
    a1 = orientation(img1, kps)
    # img1 samples the texture through R(rot), i.e. the CONTENT appears
    # rotated by -rot in image space -> the IC angle shifts by -rot.
    dth = (float(a1[0]) - float(a0[0]) + rot + np.pi) % (2 * np.pi) - np.pi
    assert abs(dth) < 0.15
    d_st = hamming(describe(img0, kps, angles=a0), describe(img1, kps, angles=a1))
    assert d_st < 40 and d_up > 70, (d_st, d_up)


def test_image_pipeline_runs_with_orb_config():
    """Smoke: the full image frontend with detector=fast + oriented=True."""
    from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
    from sosvo.sensor.rig import default_rig
    from sosvo.synth.render import RoomScene, render_sequence
    from sosvo.synth.scene import make_trajectory
    from sosvo.utils.config import FrontendConfig

    cfg = FrontendConfig(
        max_features=128, pano_height=64, pano_width=512,
        descriptor_patch=16,
        detector="fast", fast_threshold=0.01, oriented=True, n_scales=2,
    )
    rig = default_rig(image_size=512)
    poses = make_trajectory(1, radius=0.4)
    room = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
    img = jax.jit(lambda P: render_sequence(rig, P, room))(poses)[0]
    luts = build_frontend_luts(rig, cfg)
    obs = jax.jit(lambda im: extract_observations(rig, luts, cfg, im))(img)
    assert int(jnp.sum(obs.valid_top)) > 8
    assert int(jnp.sum(obs.valid_bottom)) > 8
