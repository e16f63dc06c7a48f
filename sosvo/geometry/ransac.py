"""Vmapped fixed-batch RANSAC: rigid 3D-3D and essential-matrix variants.

JAX replacement for the reference's sequential Python RANSAC loops
(SURVEY.md C10). Per BASELINE.json:5 ("batched RANSAC hypotheses vmapped per
chip") there is NO data-dependent loop: a fixed number H of hypotheses is
sampled, fitted and scored entirely in parallel, then the best is selected
with argmax and refit on its inliers. With H in the hundreds this beats
adaptive-termination RANSAC on an accelerator: all hypotheses cost one fused
batched pass, and under data parallelism H scales with the device count.

Minimal-set sampling uses the Gumbel-top-k trick over the validity mask:
per hypothesis, add Gumbel noise to log(valid) and take the top S indices --
samples S *distinct* valid slots with uniform probability, no rejection loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.geom.lie import rt_to_mat, transform_points
from sosvo.geometry.align import rigid_from_three_points, umeyama
from sosvo.geometry.essential import (
    decompose_essential,
    epipolar_residual_angle,
    epipolar_residual_sin_hyps,
    fit_essential_fast,
    fit_essential_refit,
)


class RansacResult(NamedTuple):
    model: jnp.ndarray        # (4, 4) rigid transform (or assembled from E decomposition)
    inliers: jnp.ndarray      # (K,) bool inlier mask of the best refit model
    num_inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray           # () bool: enough inliers to trust the estimate


def sample_minimal_sets(key: jax.Array, valid: jnp.ndarray, n_hyps: int, set_size: int,
                        logits: jnp.ndarray | None = None) -> jnp.ndarray:
    """(H, S) distinct indices into valid slots via Gumbel-top-k.

    `logits` (optional, (K,)) biases the per-hypothesis sampling -- e.g.
    toward near points whose triangulated depth is accurate -- while invalid
    slots stay excluded. None = uniform over valid slots.

    PERF NOTES (r5): sampling is the most expensive sub-stage of the rigid
    RANSAC, and two rewrites were measured:
      - an inverse-CDF cumsum+searchsorted sampler (WITH replacement) was
        REVERTED: under the depth-biased logits it collapses hypothesis
        diversity onto the few heaviest slots and tracking robustness fell
        from 4/4 to 1/6 sequences at 1.0 px noise (0/6 at 2.0 px).
        Without-replacement sampling is load-bearing; do not retry without
        a noise-matrix sweep.
      - `lax.top_k` over the (H, K) gumbel matrix lowers to a full row
        sort; selecting the S winners by S unrolled argmax-and-mask passes
        computes the IDENTICAL gumbel-top-k sample (same winners, same
        descending order -- gumbel keys are a.s. distinct) at 66 vs 110 us
        for (512, 512, S=3) and 109 vs 686 us at c3 scale
        (1024, 2048): 6.3x. S is a small static int, so the passes unroll.
    """
    k = valid.shape[-1]
    base = jnp.zeros((k,), jnp.float32) if logits is None else logits
    logit = jnp.where(valid, base, -jnp.inf)
    g = logit[None, :] + jax.random.gumbel(key, (n_hyps, k))
    cols = jax.lax.broadcasted_iota(jnp.int32, (n_hyps, k), 1)
    idxs = []
    for _ in range(set_size):
        i = jnp.argmax(g, axis=-1).astype(jnp.int32)
        idxs.append(i)
        g = jnp.where(cols == i[:, None], -jnp.inf, g)
    return jnp.stack(idxs, axis=-1)


def _select_best(residuals: jnp.ndarray, valid: jnp.ndarray, threshold: float):
    """Score hypotheses by masked inlier count; return (best_idx, inlier_mask_of_best)."""
    inl = (residuals < threshold) & valid[None, :]
    counts = jnp.sum(inl.astype(jnp.int32), axis=-1)
    best = jnp.argmax(counts)
    return best, inl[best], counts[best]


def _bearing_neg_cos(T: jnp.ndarray, pts_prev: jnp.ndarray, rays_curr: jnp.ndarray) -> jnp.ndarray:
    """NEGATIVE cosine of the bearing error (monotone in the angle, no arccos).

    Depth-insensitive scoring: omnistereo triangulation error grows
    ~ depth^2/baseline along the ray [P2], so Euclidean 3D residuals would
    reject every far point under realistic pixel noise while angular
    residuals stay ~ pixel-noise sized at all ranges (the reference's
    spherical-reprojection inlier criterion, SURVEY.md C10). Thresholding
    -cos(err) < -cos(thr) makes EXACTLY the same inlier decisions as
    err < thr while skipping H x K arccos evaluations per frame.
    """
    pred = transform_points(T, pts_prev)
    pred = pred / jnp.maximum(jnp.linalg.norm(pred, axis=-1, keepdims=True), 1e-9)
    return -jnp.sum(pred * rays_curr, axis=-1)


def _bearing_neg_cos_hyps(T_h: jnp.ndarray, pts_prev: jnp.ndarray,
                          rays_curr: jnp.ndarray) -> jnp.ndarray:
    """`_bearing_neg_cos` for a whole hypothesis batch, as two MXU matmuls.

    The vmapped form materializes (H, K, 3) transformed-point intermediates
    and scores them with VPU elementwise math. Expanding the dot products
    instead:

        n_hk   = ray_k . (R_h p_k + t_h) = <R_h, ray_k (x) p_k> + t_h . ray_k
        den_hk = ||R_h p_k + t_h||^2
               = ||p_k||^2 + ||t_h||^2 + 2 (R_h^T t_h) . p_k

    turns the whole score into one (H, 12) @ (12, K) matmul (flattened R | t
    against flattened outer(ray, p) | ray), one (H, 3) @ (3, K) matmul, and an
    elementwise rsqrt -- MXU work with (H, K) f32 intermediates only, no
    (H, K, 3) traffic. Exactly equal to the vmapped form up to f32 rounding
    (tests/test_geometry.py).
    """
    k = pts_prev.shape[0]
    R = T_h[:, :3, :3]                                   # (H, 3, 3)
    t = T_h[:, :3, 3]                                    # (H, 3)
    outer = rays_curr[:, :, None] * pts_prev[:, None, :]  # (K, 3, 3): ray_i p_j
    rhs = jnp.concatenate([outer.reshape(k, 9), rays_curr], axis=1)  # (K, 12)
    lhs = jnp.concatenate([R.reshape(-1, 9), t], axis=1)             # (H, 12)
    n = lhs @ rhs.T                                      # (H, K) numerators
    a = jnp.einsum("hij,hi->hj", R, t)                   # R^T t, (H, 3)
    den = (jnp.sum(pts_prev * pts_prev, axis=-1)[None, :]
           + jnp.sum(t * t, axis=-1)[:, None] + 2.0 * (a @ pts_prev.T))
    return -n * jax.lax.rsqrt(jnp.maximum(den, 1e-18))


def _bearing_residual(T: jnp.ndarray, pts_prev: jnp.ndarray, rays_curr: jnp.ndarray) -> jnp.ndarray:
    """Angular error (rad) between predicted directions of transformed previous
    points and the observed current-frame bearing rays (exact; reporting path)."""
    cosang = jnp.clip(-_bearing_neg_cos(T, pts_prev, rays_curr), -1.0, 1.0)
    return jnp.arccos(cosang)


def ransac_rigid(
    key: jax.Array,
    pts_prev: jnp.ndarray,
    pts_curr: jnp.ndarray,
    valid: jnp.ndarray,
    rays_curr: jnp.ndarray | None = None,
    n_hyps: int = 512,
    threshold: float = 0.03,
    angle_threshold: float = 0.02,
    min_inliers: int = 12,
) -> RansacResult:
    """Robust 3D-3D rigid pose: T with pts_curr ~= T pts_prev.

    The reference's core frame-to-frame VO solver (SURVEY.md C11 + C10 [P1]):
    minimal sets of 3 matched triangulated points, Umeyama inner solver, refit
    on the best inlier set. Scoring is angular (bearing) when `rays_curr` is
    given -- the depth-robust criterion -- else Euclidean 3D distance.

    Hypothesis sampling is biased toward NEAR points (logits = -2 log depth,
    i.e. weight ~ 1/depth^2): omnistereo triangulation error grows ~ depth^2
    over the vertical baseline [P2], so near points produce well-conditioned
    minimal fits while far points still participate in scoring and refit.
    """
    depth2 = jnp.sum(pts_prev * pts_prev, axis=-1)
    idx = sample_minimal_sets(key, valid, n_hyps, 3,
                              logits=-jnp.log1p(depth2))
    src = pts_prev[idx]  # (H, 3, 3)
    dst = pts_curr[idx]
    # SVD-free closed form for the minimal sets: exact on 3 exact pairs, and
    # no batched-SVD Umeyama (H small SVDs per frame would dominate the
    # step). The weighted-SVD Umeyama below runs ONCE for
    # the refit, where its least-squares property matters.
    T_h = rigid_from_three_points(src, dst)  # (H, 4, 4)

    if rays_curr is None:
        pred = transform_points(T_h, pts_prev)           # (H, K, 3)
        res = jnp.linalg.norm(pred - pts_curr, axis=-1)  # (H, K)
        thr = threshold
    else:
        res = _bearing_neg_cos_hyps(T_h, pts_prev, rays_curr)
        thr = -jnp.cos(angle_threshold)
    best, inl, count = _select_best(res, valid, thr)
    T_best = T_h[best]

    # Refit on the winning inlier set, mildly downweighting far points whose
    # triangulated depth error ~ depth^2 dominates their 3D residual. (A full
    # inverse-variance 1/depth^4 weighting over-concentrates on the nearest
    # few points and can make the refit rotation ill-conditioned.)
    w = inl.astype(pts_prev.dtype) / (1.0 + depth2)
    T_refit, _ = umeyama(pts_prev, pts_curr, weights=w)

    def inliers_of(T):
        if rays_curr is None:
            r = jnp.linalg.norm(transform_points(T, pts_prev) - pts_curr, axis=-1)
        else:
            r = _bearing_neg_cos(T, pts_prev, rays_curr)
        m = (r < thr) & valid
        return m, jnp.sum(m.astype(jnp.int32))

    # Guard: keep whichever of {best hypothesis, refit} scores more inliers --
    # a degenerate refit must never lose a good consensus already found.
    inl_b, cnt_b = inliers_of(T_best)
    inl_r, cnt_r = inliers_of(T_refit)
    use_refit = cnt_r >= cnt_b
    T_sel = jnp.where(use_refit, T_refit, T_best)
    inl_f = jnp.where(use_refit, inl_r, inl_b)
    count_f = jnp.maximum(cnt_r, cnt_b)
    ok = count_f >= min_inliers
    T_final = jnp.where(ok, T_sel, jnp.eye(4, dtype=T_sel.dtype))
    return RansacResult(T_final, inl_f, count_f, ok)


def ransac_essential(
    key: jax.Array,
    rays1: jnp.ndarray,
    rays2: jnp.ndarray,
    valid: jnp.ndarray,
    n_hyps: int = 512,
    threshold: float = 0.005,
    min_inliers: int = 16,
):
    """Robust E on the sphere -> (R, t_unit) relative pose (2D-2D path).

    Minimal sets of 8 ray pairs, weighted-DLT inner fit, angular epipolar
    residual scoring (SURVEY.md C9/C10, BASELINE.json:5). Returns the
    cheirality-disambiguated (R, t) of the refit E plus the RansacResult
    whose `model` is the assembled 4x4 (unit-scale translation).
    """
    idx = sample_minimal_sets(key, valid, n_hyps, 8)
    r1 = rays1[idx]  # (H, 8, 3)
    r2 = rays2[idx]
    w8 = jnp.ones(idx.shape, dtype=rays1.dtype)
    # Hypothesis batch: inverse-iteration fit + sine scoring (no eigh, no
    # arcsin) -- the exact variants run once on the refit below.
    E_h = fit_essential_fast(r1, r2, w8)  # (H, 3, 3)

    res = epipolar_residual_sin_hyps(E_h, rays1, rays2)  # (H, K), MXU matmuls
    # sin(thr) ~= thr at these magnitudes; threshold directly.
    best, inl, _ = _select_best(res, valid, threshold)

    w = inl.astype(rays1.dtype)
    # Refit needs EXACT smallest-eigenvector quality: near pure translation
    # the normal matrix's two smallest eigenvalues cluster around the inverse
    # iteration's eps shift, and the single-vector fast fit then returns a
    # mix of the two eigenvectors (measured: 53/256 inliers recovered vs
    # 256/256 on a noise-free translation-only case). The hypothesis batch
    # can afford that failure mode -- bad hypotheses just lose the vote --
    # the refit cannot. `fit_essential_refit` is the eigh-free Rayleigh-Ritz
    # subspace fit with the same clustered-eigenvalue behavior as eigh
    # without eigh's iterative loop inside the scan.
    E_refit = fit_essential_refit(rays1, rays2, w)
    res_f = epipolar_residual_angle(E_refit, rays1, rays2)
    inl_f = (res_f < threshold) & valid
    count_f = jnp.sum(inl_f.astype(jnp.int32))
    ok = count_f >= min_inliers

    R, t, _ = decompose_essential(E_refit, rays1, rays2, inl_f.astype(rays1.dtype))
    # Assemble frame2-from-frame1; pose of frame2 in frame1 is the inverse.
    T_21 = rt_to_mat(R, t)
    T_final = jnp.where(ok, T_21, jnp.eye(4, dtype=T_21.dtype))
    return RansacResult(T_final, inl_f, count_f, ok), R, t
