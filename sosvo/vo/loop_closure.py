"""Loop-closure detection + pose-graph trajectory refinement (config c3).

The reference has no loop closing (frame-to-frame VO [P1]); BASELINE.json:9
mandates "pose-graph optimization + loop constraints". Pipeline:

  1. keyframes at a fixed stride over the replayed sequence;
  2. loop candidates = all keyframe pairs at least `min_gap` keyframes apart
     (a STATIC pair list -- fixed shapes, vmapped batch processing);
  3. per pair: Hamming match of the two keyframes' stereo features + 3D-3D
     bearing-scored RANSAC; pairs with enough inliers become SE(3) edges
     weighted by inlier count;
  4. pose graph = VO odometry edges between consecutive keyframes + accepted
     loop edges; damped-GN relaxation (`sosvo/backend/pose_graph.py`);
  5. every frame's pose is corrected rigidly with its governing keyframe.

Everything after the static pair enumeration is one jitted program; the pair
batch is the natural "data" axis for sharding loop detection across chips.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from sosvo.backend.ba import BAWindow, ba_solve
from sosvo.backend.pose_graph import PoseGraph, pgo_solve
from sosvo.frontend.match import match, metric_params, unpack_bits_pm1
from sosvo.geom.lie import mat_inv
from sosvo.geometry.ransac import ransac_rigid
from sosvo.sensor.model import viewpoint
from sosvo.sensor.rig import OmnistereoRig
from sosvo.synth.scene import FrameObservations
from sosvo.utils.config import PipelineConfig
from sosvo.vo.pipeline import stereo_triangulate


def keyframe_indices(n_frames: int, keyframe_every: int) -> np.ndarray:
    return np.arange(0, n_frames, keyframe_every)


def governing_map(n_frames: int, kf_idx: np.ndarray) -> np.ndarray:
    """(F,) index of the keyframe governing each frame (its preceding one).

    Works for ANY keyframe index set -- stride or the scan's actual adaptive
    set (VERDICT r3 weak #3: the PGO stage used to recompute a stride and
    silently optimize a different node set than the BA window used).
    """
    kf = np.asarray(kf_idx)
    gov = np.searchsorted(kf, np.arange(n_frames), side="right") - 1
    return np.clip(gov, 0, len(kf) - 1).astype(np.int32)


def loop_pairs(n_kf: int, min_gap: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (i, j) candidate pairs with j - i >= min_gap."""
    ii, jj = np.meshgrid(np.arange(n_kf), np.arange(n_kf), indexing="ij")
    m = (jj - ii) >= min_gap
    return ii[m].astype(np.int32), jj[m].astype(np.int32)


def keyframe_signatures(desc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """(n_kf, D) compact per-keyframe appearance signatures.

    Binary descriptors (packed uint32) pool to the mean +/-1 bit vector over
    the keyframe's valid features; float descriptors (SIFT) pool to the mean
    vector. Keyframes observing overlapping landmark sets share feature
    descriptors, so their pooled vectors correlate strongly while disjoint
    views decorrelate (mean of K independent +/-1 bits ~ N(0, 1/K)) -- a
    bag-of-words-style prescreen with zero vocabulary, MXU-friendly shape.
    Signatures are unit-normalized so the candidate score is a cosine
    similarity computed as ONE (n_kf, D) x (D, n_kf) matmul.
    """
    if jnp.issubdtype(desc.dtype, jnp.unsignedinteger):
        feat = unpack_bits_pm1(desc, dtype=jnp.float32)   # (n_kf, K, 256)
    else:
        feat = desc.astype(jnp.float32)                   # (n_kf, K, D)
    w = valid.astype(jnp.float32)[..., None]
    sig = jnp.sum(feat * w, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1.0)
    return sig / jnp.maximum(jnp.linalg.norm(sig, axis=-1, keepdims=True), 1e-9)


def select_loop_candidates(sig: jnp.ndarray, min_gap: int, max_candidates: int):
    """Top-M candidate pairs by signature similarity (static shapes).

    The full K x K descriptor match runs only on these M pairs, making loop
    detection O(n_kf * M_match) instead of O(n_kf^2 * M_match) (VERDICT r1
    item 4: the PGO solve scales to arbitrary N but producing its loop edges
    didn't). The signature prescreen itself is one small matmul.

    Returns (pi, pj, ok): (M,) indices with pj - pi >= min_gap and a mask for
    slots beyond the number of admissible pairs.
    """
    n_kf = sig.shape[0]
    sim = sig @ sig.T                                     # (n_kf, n_kf) MXU
    ii = jax.lax.broadcasted_iota(jnp.int32, (n_kf, n_kf), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (n_kf, n_kf), 1)
    admissible = (jj - ii) >= min_gap
    scores = jnp.where(admissible, sim, -jnp.inf).reshape(-1)
    top, idx = jax.lax.top_k(scores, max_candidates)
    pi = (idx // n_kf).astype(jnp.int32)
    pj = (idx % n_kf).astype(jnp.int32)
    return pi, pj, jnp.isfinite(top)


def _kf_features(rig: OmnistereoRig, cfg: PipelineConfig, obs_kf: FrameObservations):
    """Stereo-triangulated features for each keyframe (vmapped)."""

    def one(o):
        pts, desc, rays, az, valid, ray_b = stereo_triangulate(rig, o, cfg)
        return pts, desc, rays, ray_b, valid

    return jax.vmap(one)(obs_kf)


def detect_loops(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    obs_kf: FrameObservations,
    min_gap: int = 3,
    min_inliers: int = 30,
    key: jax.Array | None = None,
    max_candidates: int | None = None,
):
    """Loop edges between keyframes: (ei, ej, T_meas, w) with w=0 for misses.

    Edge semantics match `sosvo/backend/pose_graph.py`: an accepted pair
    (i, j) yields an edge with endpoints (ei=j, ej=i) measuring
    X_j @ X_i^-1 (the RANSAC relative pose mapping i-frame points to j).

    `max_candidates=M` switches from all-pairs to the signature prescreen
    (`select_loop_candidates`): only the top-M pairs by pooled-descriptor
    cosine similarity get the full K x K match + RANSAC + two-frame BA, so
    detection cost is O(M) instead of O(n_kf^2) -- the long-trajectory mode
    that matches `sosvo/dist/pgo_time.py`'s scaling (SURVEY.md section 5.7).
    """
    n_kf = obs_kf.valid_top.shape[0]
    if key is None:
        key = jax.random.PRNGKey(17)
    feats = _kf_features(rig, cfg, obs_kf)
    pts, desc, ray_t, ray_b, valid = feats
    if max_candidates is None:
        pi, pj = loop_pairs(n_kf, min_gap)
        pair_ok = jnp.ones((pi.shape[0],), bool)
    else:
        sig = keyframe_signatures(desc, valid)
        pi, pj, pair_ok = select_loop_candidates(sig, min_gap, max_candidates)
    keys = jax.random.split(key, pi.shape[0])
    T_meas, w = loop_edges_for_pairs(rig, cfg, feats, pi, pj, keys, min_inliers)
    w = w * pair_ok.astype(w.dtype)  # zero out prescreen padding slots
    return jnp.asarray(pj), jnp.asarray(pi), T_meas, w


def loop_edges_for_pairs(rig, cfg, feats, pi, pj, keys, min_inliers: int):
    """Evaluate candidate pairs -> (T_meas, w); the parallelizable core.

    `feats` is the `_kf_features` tuple (replicated across devices); the pair
    arrays are the natural "data" axis for sharding loop detection across
    chips (`sosvo/dist/loops_dist.py` runs exactly this function per shard).
    """
    pts, desc, ray_t, ray_b, valid = feats
    vps = jnp.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    eye4 = jnp.eye(4, dtype=jnp.float32)

    def one_pair(i, j, k):
        metric, max_dist = metric_params(cfg.frontend)
        m = match(desc[i], desc[j], valid[i], valid[j],
                  max_distance=max_dist,
                  ratio=cfg.frontend.match_ratio,
                  metric=metric)
        pair_valid = m.valid & valid[i] & valid[j][m.idx_b]
        rays_j = ray_t[j][m.idx_b]
        rr = ransac_rigid(
            k, pts[i], pts[j][m.idx_b], pair_valid,
            rays_curr=rays_j,
            n_hyps=cfg.ransac.n_hyps,
            angle_threshold=cfg.ransac.rigid_angle_threshold,
            min_inliers=min_inliers,
        )
        # Two-frame bundle adjustment on the inliers: a raw pairwise pose is
        # biased by frame-i triangulation depth noise, which (unlike the
        # adjacent-frame case) does NOT cancel across a wide loop baseline.
        # Letting the matched points float, constrained by all four bearings
        # (2 frames x 2 views), removes that bias -- loop edges must be more
        # accurate than the drift they correct or PGO makes things worse.
        w_obs = (rr.inliers & pair_valid).astype(jnp.float32)
        rays4 = jnp.stack([
            jnp.stack([ray_t[i], ray_b[i]], axis=1),                      # frame i
            jnp.stack([rays_j, ray_b[j][m.idx_b]], axis=1),               # frame j
        ])                                                                # (2, K, 2, 3)
        win = BAWindow(
            X=jnp.stack([eye4, rr.model]),
            landmarks=pts[i],
            rays=rays4,
            weights=jnp.broadcast_to(w_obs[None, :, None], (2, w_obs.shape[0], 2)),
            viewpoints=vps,
        )
        res = ba_solve(win, iters=4, anchor=0)
        T_edge = jnp.where(rr.ok, res.X[1], rr.model)
        w = jnp.where(rr.ok, jnp.minimum(rr.num_inliers.astype(jnp.float32) / min_inliers, 4.0), 0.0)
        return T_edge, w

    # lax.map (chunked), not vmap: vmapping the matcher over all O(n_kf^2)
    # pairs would materialize every pair's K x K distance matrix at once
    # (terabytes at c3 scale); mapping runs pairs in small batches.
    T_meas, w = jax.lax.map(
        lambda args: one_pair(*args),
        (jnp.asarray(pi), jnp.asarray(pj), keys),
        batch_size=8,
    )
    return T_meas, w


def pgo_refine_trajectory(
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    obs_seq: FrameObservations,
    T_world_seq: jnp.ndarray,
    min_gap: int = 3,
    min_inliers: int = 30,
    iters: int = 10,
    odom_weight: float = 1.0,
    max_candidates: int | None = None,
    robust: str = "none",
    robust_delta: float = 0.1,
    kf_idx: np.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Close loops over a replayed trajectory; returns (corrected poses, n_loops).

    `T_world_seq`: (F, 4, 4) world-from-rig VO estimates. Non-keyframe poses
    are corrected rigidly with their governing (preceding) keyframe.

    `kf_idx`: the scan's ACTUAL keyframe frame indices (host numpy, e.g.
    `np.nonzero(outs.is_keyframe)[0]` from the BA replay) so the pose graph
    optimizes the same node set the BA window used -- essential in adaptive
    keyframe mode. None falls back to the stride schedule.
    """
    n_frames = T_world_seq.shape[0]
    if kf_idx is None:
        kf_idx = keyframe_indices(n_frames, cfg.keyframe_every)
    kf_idx = np.asarray(kf_idx)
    n_kf = len(kf_idx)
    gov = jnp.asarray(governing_map(n_frames, kf_idx))
    kf_idx_j = jnp.asarray(kf_idx)

    # ONE jitted program end to end: run eagerly, every op here is its own
    # dispatch with its own small compile.
    def leg(obs_seq, T_world_seq):
        obs_kf = jax.tree.map(lambda x: x[kf_idx_j], obs_seq)
        X_kf = jax.vmap(mat_inv)(T_world_seq[kf_idx_j])

        # Odometry edges between consecutive keyframes from the VO estimates.
        oi = jnp.arange(1, n_kf, dtype=jnp.int32)
        oj = jnp.arange(0, n_kf - 1, dtype=jnp.int32)
        T_odom = jnp.einsum("nij,njk->nik", X_kf[oi], jax.vmap(mat_inv)(X_kf[oj]))
        w_odom = jnp.full((n_kf - 1,), odom_weight, jnp.float32)

        li, lj, T_loop, w_loop = detect_loops(rig, cfg, obs_kf, min_gap,
                                              min_inliers,
                                              max_candidates=max_candidates)

        g = PoseGraph(
            X=X_kf,
            node_valid=jnp.ones((n_kf,), bool),
            ei=jnp.concatenate([oi, li]),
            ej=jnp.concatenate([oj, lj]),
            T_meas=jnp.concatenate([T_odom, T_loop]),
            w=jnp.concatenate([w_odom, w_loop]),
        )
        res = pgo_solve(g, iters=iters, robust=robust, robust_delta=robust_delta)

        # Rigid per-segment correction: frame f governed by keyframe k(f).
        T_kf_old = T_world_seq[kf_idx_j]                 # world-from-rig (old)
        T_kf_new = jax.vmap(mat_inv)(res.X)              # world-from-rig (new)
        corr = jnp.einsum("nij,njk->nik", T_kf_new, jax.vmap(mat_inv)(T_kf_old))
        T_corrected = jnp.einsum("fij,fjk->fik", corr[gov], T_world_seq)
        n_loops = jnp.sum((w_loop > 0).astype(jnp.int32))
        return T_corrected, n_loops

    return jax.jit(leg)(obs_seq, T_world_seq)
