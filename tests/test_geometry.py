"""Geometry tests: matching, triangulation, essential matrix, RANSAC
(SURVEY.md SS4.1 and SS4.4 property tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sosvo.frontend import match as fm
from sosvo.geom.lie import geodesic_angle, mat_inv, se3_exp, so3_exp, transform_points
from sosvo.geometry.essential import (
    decompose_essential,
    epipolar_residual_angle,
    essential_from_rt,
    fit_essential,
)
from sosvo.geometry.ransac import ransac_essential, ransac_rigid, sample_minimal_sets
from sosvo.geometry.triangulate import midpoint_triangulate
from sosvo.sensor.model import viewpoint
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_frame


# ---------------------------------------------------------------- matching

@pytest.mark.parametrize("ka,kb", [(96, 128), (2048, 2048)])
def test_hamming_mxu_equals_xor(ka, kb):
    """bf16 +/-1 operands with f32 accumulation are exact for 256 bits."""
    key = jax.random.PRNGKey(0)
    a = jax.random.bits(key, (ka, 8), dtype=jnp.uint32)
    b = jax.random.bits(jax.random.PRNGKey(1), (kb, 8), dtype=jnp.uint32)
    d1 = fm.hamming_matrix_xor(a, b)
    d2 = fm.hamming_matrix_mxu(a, b)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_match_identity_permutation():
    key = jax.random.PRNGKey(2)
    desc = jax.random.bits(key, (64, 8), dtype=jnp.uint32)
    perm = jax.random.permutation(jax.random.PRNGKey(3), 64)
    valid = jnp.ones(64, bool)
    res = fm.match(desc, desc[perm], valid, valid)
    # Every feature matches its permuted twin exactly (distance 0).
    inv = jnp.argsort(perm)
    assert bool(jnp.all(res.valid))
    np.testing.assert_array_equal(np.asarray(res.idx_b), np.asarray(inv))
    np.testing.assert_allclose(np.asarray(res.dist), 0.0)


def test_match_respects_validity_and_ratio():
    key = jax.random.PRNGKey(4)
    desc_a = jax.random.bits(key, (32, 8), dtype=jnp.uint32)
    desc_b = jnp.concatenate([desc_a, desc_a], axis=0)  # every A has TWO perfect twins
    va = jnp.ones(32, bool)
    vb = jnp.ones(64, bool)
    res = fm.match(desc_a, desc_b, va, vb, ratio=0.8)
    # Ratio test must kill all matches (best == second-best == 0 distance).
    assert not bool(jnp.any(res.valid))
    # Masking the duplicates restores the matches.
    vb2 = vb.at[32:].set(False)
    res2 = fm.match(desc_a, desc_b, va, vb2, ratio=0.8)
    assert bool(jnp.all(res2.valid))


def test_column_band_penalty_wrap():
    ca = jnp.array([0.0, 510.0])
    cb = jnp.array([2.0, 2.0])
    p = fm.column_band_penalty(ca, cb, max_delta=5.0, wrap=512)
    assert float(p[0, 0]) == 0.0
    assert float(p[1, 0]) == 0.0  # 510 vs 2 wraps to distance 4


# ------------------------------------------------------------ triangulation

def test_triangulation_recovers_synthetic_depth():
    rig = default_rig()
    scene = make_scene(jax.random.PRNGKey(5), n_frames=3, n_landmarks=2048)
    obs = observe_frame(rig, scene, jnp.asarray(1), 512, jax.random.PRNGKey(6))
    tri = midpoint_triangulate(
        obs.ray_top, obs.ray_bottom, viewpoint(rig.top), viewpoint(rig.bottom)
    )
    pts_rig = transform_points(mat_inv(scene.poses[1]), scene.landmarks)
    gt = pts_rig[obs.lm_id]
    ok = obs.valid & tri.valid
    assert int(jnp.sum(ok)) > 100
    err = jnp.linalg.norm(tri.points - gt, axis=-1)
    # f32 midpoint triangulation error grows ~quadratically with range over a
    # fixed vertical baseline; bound the error relative to the point's range.
    rel = err / jnp.maximum(tri.depth_top, 1.0)
    assert float(jnp.max(jnp.where(ok, rel, 0.0))) < 2e-3
    assert float(jnp.median(jnp.where(ok, err, 0.0))) < 5e-3


def test_triangulation_rejects_parallel_rays():
    r = jnp.array([[1.0, 0.0, 0.0]])
    tri = midpoint_triangulate(r, r, jnp.zeros(3), jnp.array([0.0, 0.0, -0.1]))
    assert not bool(tri.valid[0])


# ---------------------------------------------------------------- essential

def _random_ray_pairs(key, n, R, t):
    """Generate exact ray correspondences under X2 = R X1 + t."""
    pts = jax.random.normal(key, (n, 3)) * 3.0 + jnp.array([0.0, 0.0, 2.0])
    r1 = pts / jnp.linalg.norm(pts, axis=-1, keepdims=True)
    pts2 = pts @ R.T + t
    r2 = pts2 / jnp.linalg.norm(pts2, axis=-1, keepdims=True)
    return r1, r2


def test_essential_fit_and_residual():
    R = so3_exp(jnp.array([0.05, -0.1, 0.3]))
    t = jnp.array([0.2, 0.1, -0.05])
    r1, r2 = _random_ray_pairs(jax.random.PRNGKey(7), 64, R, t)
    E = fit_essential(r1, r2, jnp.ones(64))
    res = epipolar_residual_angle(E, r1, r2)
    assert float(jnp.max(res)) < 1e-3
    # Fitted E matches the analytic E = [t]x R up to sign.
    E_true = essential_from_rt(R, t / jnp.linalg.norm(t))
    diff = min(
        float(jnp.linalg.norm(E - E_true)),
        float(jnp.linalg.norm(E + E_true)),
    )
    assert diff < 5e-3, diff


def test_essential_decomposition_recovers_pose():
    R = so3_exp(jnp.array([-0.1, 0.2, 0.15]))
    t = jnp.array([0.15, -0.2, 0.1])
    t_unit = t / jnp.linalg.norm(t)
    r1, r2 = _random_ray_pairs(jax.random.PRNGKey(8), 128, R, t)
    E = fit_essential(r1, r2, jnp.ones(128))
    R_est, t_est, support = decompose_essential(E, r1, r2, jnp.ones(128))
    np.testing.assert_allclose(np.asarray(R_est), np.asarray(R), atol=2e-3)
    t_err = min(float(jnp.linalg.norm(t_est - t_unit)), float(jnp.linalg.norm(t_est + t_unit)))
    # Cheirality should fix the sign: direct comparison must be the small one.
    np.testing.assert_allclose(np.asarray(t_est), np.asarray(t_unit), atol=5e-3)
    assert float(support) > 100


# ------------------------------------------------------------------ RANSAC

def test_sample_minimal_sets_distinct_and_valid():
    valid = jnp.arange(100) % 3 == 0  # 34 valid slots
    idx = sample_minimal_sets(jax.random.PRNGKey(9), valid, 64, 8)
    v = np.asarray(valid)
    i = np.asarray(idx)
    assert v[i].all()
    for row in i:
        assert len(set(row.tolist())) == 8


def test_ransac_rigid_with_outliers():
    # SURVEY.md SS4.4: <=30% outliers -> pose recovered within tolerance.
    key = jax.random.PRNGKey(10)
    pts = jax.random.normal(key, (256, 3)) * 2.0
    T_true = se3_exp(jnp.array([0.05, -0.08, 0.12, 0.1, 0.05, -0.02]))
    curr = transform_points(T_true, pts)
    # 30% outliers
    n_out = 76
    curr = curr.at[:n_out].add(jax.random.normal(jax.random.PRNGKey(11), (n_out, 3)) * 1.5)
    valid = jnp.ones(256, bool)
    res = ransac_rigid(jax.random.PRNGKey(12), pts, curr, valid, n_hyps=256)
    assert bool(res.ok)
    assert int(res.num_inliers) >= 256 - n_out - 10
    np.testing.assert_allclose(np.asarray(res.model), np.asarray(T_true), atol=2e-3)


def test_ransac_rigid_respects_mask():
    pts = jax.random.normal(jax.random.PRNGKey(13), (128, 3))
    T_true = se3_exp(jnp.array([0.0, 0.1, 0.0, 0.2, 0.0, 0.0]))
    curr = transform_points(T_true, pts)
    curr = curr.at[64:].set(999.0)  # garbage in invalid slots
    valid = jnp.arange(128) < 64
    res = ransac_rigid(jax.random.PRNGKey(14), pts, curr, valid, n_hyps=128)
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.model), np.asarray(T_true), atol=2e-3)
    assert not bool(jnp.any(res.inliers[64:]))


def test_ransac_essential_with_outliers():
    R = so3_exp(jnp.array([0.02, 0.05, 0.2]))
    t = jnp.array([0.1, 0.05, 0.02])
    r1, r2 = _random_ray_pairs(jax.random.PRNGKey(15), 256, R, t)
    # 25% outliers: random rays
    n_out = 64
    bad = jax.random.normal(jax.random.PRNGKey(16), (n_out, 3))
    bad = bad / jnp.linalg.norm(bad, axis=-1, keepdims=True)
    r2 = r2.at[:n_out].set(bad)
    valid = jnp.ones(256, bool)
    res, R_est, t_est = ransac_essential(jax.random.PRNGKey(17), r1, r2, valid, n_hyps=256)
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(R_est), np.asarray(R), atol=5e-3)
    t_unit = t / jnp.linalg.norm(t)
    np.testing.assert_allclose(np.asarray(t_est), np.asarray(t_unit), atol=2e-2)


def test_ransac_rigid_property_random_motions():
    """Property sweep (SURVEY.md SS4.4): random rigid motions + point clouds
    with 30% outliers, many seeds -> pose recovered within tolerance."""
    from sosvo.geom.lie import se3_exp

    for seed in range(8):
        key = jax.random.PRNGKey(100 + seed)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        T_gt = se3_exp(jax.random.normal(k1, (6,)) * jnp.array([0.2] * 3 + [0.15] * 3))
        pts = jax.random.normal(k2, (256, 3)) * 2.0 + jnp.array([0.0, 0.0, 1.5])
        pts_c = transform_points(T_gt, pts)
        n_out = 76  # ~30%
        pts_c = pts_c.at[:n_out].add(jax.random.normal(k3, (n_out, 3)) * 2.0)
        valid = jnp.ones((256,), bool)
        rr = ransac_rigid(k4, pts, pts_c, valid, n_hyps=512, threshold=0.05,
                          min_inliers=20)
        assert bool(rr.ok), f"seed {seed}"
        t_err = float(jnp.linalg.norm(rr.model[:3, 3] - T_gt[:3, 3]))
        r_err = float(geodesic_angle(rr.model[:3, :3], T_gt[:3, :3]))
        assert t_err < 0.02, (seed, t_err)
        assert r_err < 0.02, (seed, r_err)


def test_fit_essential_fast_matches_eigh():
    """Inverse-iteration E fit ~ exact eigh fit on minimal sets."""
    from sosvo.geometry.essential import fit_essential_fast

    R = so3_exp(jnp.array([0.05, -0.1, 0.3]))
    t = jnp.array([0.2, 0.1, -0.05])
    for seed in range(4):
        r1, r2 = _random_ray_pairs(jax.random.PRNGKey(60 + seed), 8, R, t)
        w = jnp.ones(8)
        E_fast = fit_essential_fast(r1, r2, w)
        res = epipolar_residual_angle(E_fast, r1, r2)
        assert float(jnp.max(res)) < 1e-3, (seed, float(jnp.max(res)))


def test_bearing_neg_cos_hyps_matches_vmapped():
    """MXU-matmul hypothesis scoring == the vmapped elementwise form."""
    from sosvo.geom.lie import se3_exp
    from sosvo.geometry.ransac import _bearing_neg_cos, _bearing_neg_cos_hyps

    key = jax.random.PRNGKey(77)
    kH, kP, kR = jax.random.split(key, 3)
    T_h = se3_exp(0.3 * jax.random.normal(kH, (32, 6)))
    pts = 4.0 * jax.random.normal(kP, (64, 3))
    rays = jax.random.normal(kR, (64, 3))
    rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
    ref = jax.vmap(lambda T: _bearing_neg_cos(T, pts, rays))(T_h)
    got = _bearing_neg_cos_hyps(T_h, pts, rays)
    assert float(jnp.max(jnp.abs(got - ref))) < 2e-5


def test_epipolar_residual_sin_hyps_matches_vmapped():
    """MXU-matmul epipolar scoring == the vmapped elementwise form."""
    from sosvo.geometry.essential import (epipolar_residual_sin,
                                          epipolar_residual_sin_hyps)

    key = jax.random.PRNGKey(88)
    kE, k1, k2 = jax.random.split(key, 3)
    E_h = jax.random.normal(kE, (16, 3, 3))
    E_h = E_h / jnp.linalg.norm(E_h, axis=(-2, -1), keepdims=True)
    r1 = jax.random.normal(k1, (64, 3))
    r1 = r1 / jnp.linalg.norm(r1, axis=-1, keepdims=True)
    r2 = jax.random.normal(k2, (64, 3))
    r2 = r2 / jnp.linalg.norm(r2, axis=-1, keepdims=True)
    ref = jax.vmap(lambda E: epipolar_residual_sin(E, r1, r2))(E_h)
    got = epipolar_residual_sin_hyps(E_h, r1, r2)
    assert float(jnp.max(jnp.abs(got - ref))) < 2e-6


def test_refine_bearings_analytic_jacobian_matches_autodiff():
    """The closed-form GN step in refine_pose_bearings == a jacfwd reference."""
    from sosvo.backend.refine import bearing_residuals, refine_pose_bearings
    from sosvo.geom.lie import se3_exp

    key = jax.random.PRNGKey(5)
    kP, kR, kT = jax.random.split(key, 3)
    pts = 3.0 * jax.random.normal(kP, (40, 3))
    T_gt = se3_exp(jnp.array([0.05, -0.02, 0.1, 0.2, -0.1, 0.05]))
    q = pts @ T_gt[:3, :3].T + T_gt[:3, 3]
    rays = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    rays = rays + 0.002 * jax.random.normal(kR, rays.shape)
    rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
    w = jnp.ones(40)
    T0 = se3_exp(jnp.array([0.03, 0.01, -0.02, 0.05, 0.02, -0.04])) @ T_gt

    def refine_jacfwd(T_init, iters=6, damping=1e-4, huber_delta=0.01):
        def residual_vec(delta, T, ww):
            r = bearing_residuals(se3_exp(delta) @ T, pts, rays)
            return (r * ww[:, None]).reshape(-1)

        def step(_, T):
            zero = jnp.zeros(6, dtype=T.dtype)
            r_raw = bearing_residuals(T, pts, rays)
            nrm = jnp.linalg.norm(r_raw, axis=-1)
            hw = jnp.sqrt(jnp.where(nrm <= huber_delta, 1.0,
                                    huber_delta / jnp.maximum(nrm, 1e-12)))
            ww = w * hw
            J = jax.jacfwd(residual_vec)(zero, T, ww)
            r = residual_vec(zero, T, ww)
            H = J.T @ J + damping * jnp.eye(6, dtype=T.dtype)
            delta = -jnp.linalg.solve(H, J.T @ r)
            return se3_exp(delta) @ T

        return jax.lax.fori_loop(0, iters, step, T_init)

    T_ref = refine_jacfwd(T0)
    T_new = refine_pose_bearings(T0, pts, rays, w)
    assert float(jnp.max(jnp.abs(T_new - T_ref))) < 1e-5


def test_refit_matches_eigh_general():
    """Rayleigh-Ritz subspace refit == exact eigh fit on general motion."""
    from sosvo.geometry.essential import fit_essential, fit_essential_refit

    R = so3_exp(jnp.array([0.05, -0.1, 0.3]))
    t = jnp.array([0.2, 0.1, -0.05])
    for seed in range(4):
        r1, r2 = _random_ray_pairs(jax.random.PRNGKey(80 + seed), 64, R, t)
        w = jnp.ones(64)
        E_eigh = fit_essential(r1, r2, w)
        E_sub = fit_essential_refit(r1, r2, w)
        res = epipolar_residual_angle(E_sub, r1, r2)
        res_e = epipolar_residual_angle(E_eigh, r1, r2)
        assert float(jnp.max(res)) < float(jnp.max(res_e)) + 1e-5


def test_refit_matches_eigh_pure_translation():
    """The clustered-eigenvalue case that breaks the single-vector fast fit:
    pure translation. The subspace refit must retain eigh's exactness
    (this is why the refit is not `fit_essential_fast`)."""
    from sosvo.geometry.essential import (
        fit_essential_fast,
        fit_essential_refit,
    )

    for t in (jnp.array([0.05, 0.02, 0.0]), jnp.array([0.0, 0.0, 0.1])):
        r1, r2 = _random_ray_pairs(jax.random.PRNGKey(90), 256, jnp.eye(3), t)
        w = jnp.ones(256)
        res_sub = epipolar_residual_angle(fit_essential_refit(r1, r2, w), r1, r2)
        res_fast = epipolar_residual_angle(fit_essential_fast(r1, r2, w), r1, r2)
        # subspace: every pair an inlier at the pipeline threshold
        assert float(jnp.max(res_sub)) < 5e-3, float(jnp.max(res_sub))
        # and it genuinely fixes a failure the fast fit HAS on this data
        assert float(jnp.max(res_fast)) > float(jnp.max(res_sub))


def test_umeyama_near_collinear_no_nan():
    """Regression (r3): Horn/QCP Procrustes on a near-COLLINEAR point set.

    The quaternion matrix N then has a near-degenerate +-lambda_max pair; f32
    Newton can land a hair below lambda_max, making the inverse-iteration
    shift matrix slightly indefinite -- the unrolled Cholesky's old 1e-30
    sqrt floor let inv_d reach ~1e15 and later columns overflow inf -> NaN.
    Hit in production by ate_rmse on short smooth trajectories."""
    import numpy as np

    from sosvo.eval.ate import ate_rmse
    from sosvo.geometry.align import umeyama

    for seed in range(32):
        k = jax.random.PRNGKey(seed)
        d = jax.random.normal(k, (3,))
        d = d / jnp.linalg.norm(d)
        pts = jnp.linspace(0.0, 0.1, 5)[:, None] * d[None]
        noisy = pts + 1e-4 * jax.random.normal(jax.random.fold_in(k, 1), (5, 3))
        T, _ = umeyama(noisy, pts)
        assert bool(jnp.all(jnp.isfinite(T))), seed
        r, _ = ate_rmse(noisy, pts)
        assert np.isfinite(float(r)) and float(r) < 1e-3, (seed, float(r))
