"""Essential-matrix estimation on the sphere, batched pure JAX.

JAX replacement for the reference's omnidirectional epipolar module
(SURVEY.md C9: 8-point-style E estimation from unit-ray correspondences,
`r2^T E r1 = 0` directly on sphere rays -- no image-plane normalization step
exists for omnidirectional cameras, the rays ARE the normalized coordinates).
Required by BASELINE.json:5 ("RANSAC essential-matrix estimation on the
sphere") and config c1 (BASELINE.json:7).

Convention: for a point X seen as ray r1 in frame 1 and r2 in frame 2, with
frame-2-from-frame-1 motion X2 = R X1 + t, the constraint is
    r2^T E r1 = 0,   E = [t]_x R.

Fit: weighted DLT. Each correspondence contributes a row a = vec(r2 r1^T)
(row-major pairing with vec(E)); the solution is the eigenvector of the
smallest eigenvalue of sum_i w_i a_i a_i^T (9x9 symmetric eigh -- batched,
no tall SVD). Weights make fixed-size masked sets and RANSAC
minimal-set selection exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sosvo.geom.lie import hat
from sosvo.geometry.triangulate import midpoint_triangulate


def essential_rows(rays1: jnp.ndarray, rays2: jnp.ndarray) -> jnp.ndarray:
    """Per-correspondence DLT rows: (..., N, 9) with a = vec(r2 r1^T)."""
    outer = rays2[..., :, None] * rays1[..., None, :]  # (..., N, 3, 3): r2_j r1_k
    return outer.reshape(outer.shape[:-2] + (9,))


def _inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (adjugate/determinant) 3x3 inverse; batched, no LU loop."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
        jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
    ], axis=-2)
    return adj / (det[..., None, None] + jnp.where(det[..., None, None] >= 0, 1e-30, -1e-30))


def _chol9(M: jnp.ndarray) -> jnp.ndarray:
    """Batched 9x9 Cholesky, fully unrolled into elementwise ops.

    `jnp.linalg.cholesky` on a (H, 9, 9) batch lowers to XLA's general
    blocked-loop kernel; this unrolled form is one fused elementwise
    program. Unrolling is exact, not an approximation: same flops, static
    schedule, no loop kernel.
    """
    n = 9
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        # Floor at 1e-12 (not 1e-30): a slightly INDEFINITE input -- e.g. the
        # Procrustes shift matrix when f32 Newton lands a hair below
        # lambda_max -- would otherwise give d ~ 1e-15, inv_d ~ 1e15, and the
        # squared terms of later columns overflow to inf and cascade to NaN
        # (inf - inf). With the floor, intermediates stay finite and the
        # inverse-iteration caller is insensitive to the sign/scale noise.
        d = jnp.sqrt(jnp.maximum(s, 1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    zero = jnp.zeros_like(M[..., 0, 0])
    rows = [jnp.stack([L[i][j] if j <= i else zero for j in range(n)], axis=-1)
            for i in range(n)]
    return jnp.stack(rows, axis=-2)


def _chol9_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(L L^T) x = b by unrolled forward+back substitution; b: (..., 9)."""
    n = 9
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)


def fit_essential(rays1: jnp.ndarray, rays2: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """Weighted 8-point fit on the sphere -> (..., 3, 3) essential matrix."""
    a = essential_rows(rays1, rays2)
    ata = jnp.einsum("...ni,...nj->...ij", a * weights[..., None], a)
    # Smallest-eigenvalue eigenvector of the 9x9 normal matrix.
    _, vecs = jnp.linalg.eigh(ata)
    e = vecs[..., :, 0]
    E = e.reshape(e.shape[:-1] + (3, 3))
    # Scale-normalize (E is homogeneous).
    return E / jnp.maximum(jnp.linalg.norm(E, axis=(-2, -1), keepdims=True), 1e-12)


def fit_essential_fast(rays1: jnp.ndarray, rays2: jnp.ndarray,
                       weights: jnp.ndarray, iters: int = 2) -> jnp.ndarray:
    """Smallest-eigenvector fit by Cholesky inverse iteration (no eigh).

    For RANSAC minimal sets the 9x9 normal matrix has an (almost) exact null
    vector, so one-two inverse iterations on (M + eps*I) isolate it: the null
    direction is amplified by 1/eps vs 1/lambda_i for the rest. Batched 9x9
    Cholesky + triangular solves avoid the iterative loop of a batched
    eigh over the whole hypothesis batch. The exact eigh fit remains for
    the final refit.
    """
    from sosvo.utils import debug

    a = essential_rows(rays1, rays2)
    M = jnp.einsum("...ni,...nj->...ij", a * weights[..., None], a)
    scale = jnp.trace(M, axis1=-2, axis2=-1)[..., None, None] / 9.0 + 1e-12
    eps = 1e-5
    Ms = M / scale + eps * jnp.eye(9, dtype=M.dtype)
    # Under the checkify sanitizer the unrolled form's per-op instrumentation
    # explodes compile time; fall back to the library kernels there (same
    # factorization -- see sosvo/utils/debug.py::UNROLLED_SOLVERS).
    unrolled = debug.UNROLLED_SOLVERS
    L = _chol9(Ms) if unrolled else jnp.linalg.cholesky(Ms)
    v = jnp.ones(M.shape[:-2] + (9,), M.dtype) / 3.0

    for _ in range(iters):
        if unrolled:
            v = _chol9_solve(L, v)
        else:
            y = jax.scipy.linalg.solve_triangular(L, v[..., None], lower=True)
            v = jax.scipy.linalg.solve_triangular(
                jnp.swapaxes(L, -1, -2), y, lower=False)[..., 0]
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)

    E = v.reshape(M.shape[:-2] + (3, 3))
    return E / jnp.maximum(jnp.linalg.norm(E, axis=(-2, -1), keepdims=True), 1e-12)


def _eigvec_smallest_sym3(P: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3.

    Closed form, branch-free: smallest eigenvalue via the trigonometric
    formula for symmetric 3x3 matrices, eigenvector as the largest-norm cross
    product of rows of (P - lam I) (the null direction of that rank-2
    matrix). No iterative eigh -- this runs on the per-frame refit path.
    """
    q = jnp.trace(P, axis1=-2, axis2=-1) / 3.0
    A = P - q[..., None, None] * jnp.eye(3, dtype=P.dtype)
    p2 = jnp.sum(A * A, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(A / p[..., None, None])
    phi = jnp.arccos(jnp.clip(detB / 2.0, -1.0, 1.0)) / 3.0
    # Eigenvalues are q + 2p cos(phi + 2k pi/3); k=1 (phi + 2pi/3) is smallest.
    lam = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    B = P - lam[..., None, None] * jnp.eye(3, dtype=P.dtype)
    c01 = jnp.cross(B[..., 0, :], B[..., 1, :])
    c02 = jnp.cross(B[..., 0, :], B[..., 2, :])
    c12 = jnp.cross(B[..., 1, :], B[..., 2, :])
    cands = jnp.stack([c01, c02, c12], axis=-2)          # (..., 3, 3)
    nrm = jnp.linalg.norm(cands, axis=-1)
    best = jnp.argmax(nrm, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None].repeat(3, -1), axis=-2)[..., 0, :]
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


def fit_essential_refit(rays1: jnp.ndarray, rays2: jnp.ndarray,
                        weights: jnp.ndarray) -> jnp.ndarray:
    """Exact-quality smallest-eigenvector fit WITHOUT eigh (refit path).

    Rayleigh-Ritz: shifted-Cholesky inverse iteration on a 3-COLUMN block
    captures the SPAN of the bottom eigenvectors even when their eigenvalues
    cluster (the near-pure-translation case where single-vector inverse
    iteration returns a mixture -- see `ransac_essential`); the projected
    3x3 eigenproblem V^T M V then separates them exactly in closed form.
    A 9x9 eigh lowers to an iterative Jacobi loop; this is three
    triangular solves and a closed-form 3x3 -- an eigh-free frame that
    keeps the eigh's clustered-eigenvalue correctness
    (tests/test_geometry.py::test_refit_matches_eigh*).
    """
    a = essential_rows(rays1, rays2)
    M = jnp.einsum("...ni,...nj->...ij", a * weights[..., None], a)
    scale = jnp.trace(M, axis1=-2, axis2=-1)[..., None, None] / 9.0 + 1e-12
    Mn = M / scale
    # Size switch: the unrolled Cholesky suits hypothesis BATCHES (vector
    # units amortize the scalar chain across the batch) but not a single
    # instance (batch-1 elementwise chains are pure latency); the library
    # kernel is the right call for this once-per-frame refit.
    from sosvo.utils import debug

    batched = M.ndim > 2 and debug.UNROLLED_SOLVERS
    if batched:
        L = _chol9(Mn + 1e-5 * jnp.eye(9, dtype=M.dtype))
    else:
        L = jnp.linalg.cholesky(Mn + 1e-5 * jnp.eye(9, dtype=M.dtype))
    # Fixed full-rank start: 3 columns spanning generic directions.
    V = jnp.broadcast_to(
        jnp.asarray(
            [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1],
             [1, 0, 1], [1, -1, 0], [0, 1, -1], [1, 1, 1]], M.dtype) / 3.0,
        M.shape[:-2] + (9, 3))
    for _ in range(2):
        if batched:
            # Unrolled triangular solves, columns moved into the batch dims.
            V = jnp.swapaxes(
                _chol9_solve(L[..., None, :, :], jnp.swapaxes(V, -1, -2)), -1, -2)
        else:
            Y = jax.scipy.linalg.solve_triangular(L, V, lower=True)
            V = jax.scipy.linalg.solve_triangular(
                jnp.swapaxes(L, -1, -2), Y, lower=False)
        # Orthonormalize (3-col Gram-Schmidt, closed form) to keep the block
        # well conditioned across iterations.
        q0 = V[..., :, 0]
        q0 = q0 / jnp.maximum(jnp.linalg.norm(q0, axis=-1, keepdims=True), 1e-30)
        q1 = V[..., :, 1] - jnp.sum(q0 * V[..., :, 1], axis=-1, keepdims=True) * q0
        q1 = q1 / jnp.maximum(jnp.linalg.norm(q1, axis=-1, keepdims=True), 1e-30)
        q2 = (V[..., :, 2]
              - jnp.sum(q0 * V[..., :, 2], axis=-1, keepdims=True) * q0
              - jnp.sum(q1 * V[..., :, 2], axis=-1, keepdims=True) * q1)
        q2 = q2 / jnp.maximum(jnp.linalg.norm(q2, axis=-1, keepdims=True), 1e-30)
        V = jnp.stack([q0, q1, q2], axis=-1)
    P = jnp.einsum("...ir,...ij,...js->...rs", V, Mn, V)   # (..., 3, 3)
    c = _eigvec_smallest_sym3(P)
    e = jnp.einsum("...ir,...r->...i", V, c)
    E = e.reshape(e.shape[:-1] + (3, 3))
    return E / jnp.maximum(jnp.linalg.norm(E, axis=(-2, -1), keepdims=True), 1e-12)


def _sym_pack(G: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) symmetric -> (..., 6) [G00, G11, G22, 2G01, 2G02, 2G12]."""
    return jnp.stack([G[..., 0, 0], G[..., 1, 1], G[..., 2, 2],
                      2.0 * G[..., 0, 1], 2.0 * G[..., 0, 2],
                      2.0 * G[..., 1, 2]], axis=-1)


def _sym_feats(r: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) rays -> (..., 6) [r0^2, r1^2, r2^2, r0r1, r0r2, r1r2] so that
    `_sym_pack(G) . _sym_feats(r) == r^T G r`."""
    return jnp.stack([r[..., 0] * r[..., 0], r[..., 1] * r[..., 1],
                      r[..., 2] * r[..., 2], r[..., 0] * r[..., 1],
                      r[..., 0] * r[..., 2], r[..., 1] * r[..., 2]], axis=-1)


def epipolar_residual_sin_hyps(E_h: jnp.ndarray, rays1: jnp.ndarray,
                               rays2: jnp.ndarray) -> jnp.ndarray:
    """`epipolar_residual_sin` for a hypothesis batch, as MXU matmuls.

    The vmapped form materializes (H, K, 3) `E r1` / `E^T r2` intermediates;
    expanding the bilinear/quadratic forms instead:

        num_hk        = |r2_k^T E_h r1_k|    = |<E_h, r2_k (x) r1_k>|
        ||E_h r1_k||^2  = r1_k^T (E_h^T E_h) r1_k
        ||E_h^T r2_k||^2 = r2_k^T (E_h E_h^T) r2_k

    i.e. one (H, 9) @ (9, K) matmul plus two (H, 6) @ (6, K) quadratic-form
    matmuls (symmetric packing), with only (H, K) f32 intermediates. Equal to
    the vmapped form up to f32 rounding (tests/test_geometry.py).
    """
    k = rays1.shape[0]
    lhs_n = E_h.reshape(-1, 9)                                   # (H, 9)
    rhs_n = (rays2[:, :, None] * rays1[:, None, :]).reshape(k, 9)  # (K, 9)
    num = jnp.abs(lhs_n @ rhs_n.T)                               # (H, K)
    G1 = jnp.einsum("hij,hik->hjk", E_h, E_h)                    # E^T E
    G2 = jnp.einsum("hij,hkj->hik", E_h, E_h)                    # E E^T
    d1 = _sym_pack(G1) @ _sym_feats(rays1).T                     # (H, K)
    d2 = _sym_pack(G2) @ _sym_feats(rays2).T
    s1 = num * jax.lax.rsqrt(jnp.maximum(d1, 1e-18))
    s2 = num * jax.lax.rsqrt(jnp.maximum(d2, 1e-18))
    return 0.5 * (s1 + s2)


def epipolar_residual_sin(E: jnp.ndarray, rays1: jnp.ndarray, rays2: jnp.ndarray) -> jnp.ndarray:
    """Symmetric SINE of the ray-to-epipolar-plane angle (no arcsin).

    Monotone in the angle and equal to it to first order, so RANSAC can
    threshold on sin(thr) ~= thr directly -- saving ~H*K transcendentals per
    frame in the hypothesis-scoring hot loop.
    """
    Er1 = jnp.einsum("...ij,...nj->...ni", E, rays1)
    Etr2 = jnp.einsum("...ji,...nj->...ni", E, rays2)
    num = jnp.abs(jnp.sum(rays2 * Er1, axis=-1))
    s1 = num / jnp.maximum(jnp.linalg.norm(Er1, axis=-1), 1e-9)
    s2 = num / jnp.maximum(jnp.linalg.norm(Etr2, axis=-1), 1e-9)
    return 0.5 * (s1 + s2)


def epipolar_residual_angle(E: jnp.ndarray, rays1: jnp.ndarray, rays2: jnp.ndarray) -> jnp.ndarray:
    """Symmetric angular distance (radians) of rays from their epipolar planes.

    For unit rays, |r2 . n| with n = E r1 / |E r1| is the sine of the angle
    between r2 and the epipolar plane of r1 -- the spherical analog of
    point-to-epiline distance (SURVEY.md C10 "angular reprojection threshold
    on sphere"). Symmetrized over both directions.
    """
    Er1 = jnp.einsum("...ij,...nj->...ni", E, rays1)
    Etr2 = jnp.einsum("...ji,...nj->...ni", E, rays2)
    num = jnp.abs(jnp.sum(rays2 * Er1, axis=-1))
    s1 = num / jnp.maximum(jnp.linalg.norm(Er1, axis=-1), 1e-9)
    s2 = num / jnp.maximum(jnp.linalg.norm(Etr2, axis=-1), 1e-9)
    return 0.5 * (jnp.arcsin(jnp.clip(s1, 0.0, 1.0)) + jnp.arcsin(jnp.clip(s2, 0.0, 1.0)))


def essential_from_rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """E = [t]_x R (unit-normalized)."""
    E = hat(t) @ R
    return E / jnp.maximum(jnp.linalg.norm(E, axis=(-2, -1), keepdims=True), 1e-12)


def decompose_essential(
    E: jnp.ndarray,
    rays1: jnp.ndarray,
    rays2: jnp.ndarray,
    weights: jnp.ndarray,
):
    """Recover (R, t_unit) from E with spherical cheirality disambiguation.

    Produces the 4 standard candidates (R1/R2 x +-t) from the SVD of E and
    selects the one maximizing the weighted count of correspondences that
    triangulate with positive range along BOTH rays -- the cheirality test
    generalized to sphere rays (no "in front of camera" plane; SURVEY.md C9).

    Returns:
      R: (..., 3, 3) rotation (frame2 from frame1).
      t: (..., 3) unit translation (scale is unobservable from E).
      support: (...,) weighted cheirality-consistent correspondence count.
    """
    # Fully closed-form candidate extraction (this runs once per frame, so
    # latency-bound serial solvers such as a 3x3 jnp.linalg.svd would
    # dominate):
    #   t: the left null direction of E (E = [t]x R => t^T E = 0), i.e. the
    #      smallest eigenvector of G = E E^T -- closed-form (adjugate)
    #      inverse-iteration steps on G + eps*I.
    #   R: Horn's cofactor identity. For E = s [t]x R with |t| = 1 and
    #      |E|_F = 1 (so s = 1/sqrt(2)):
    #          cof(E) = s^2 t t^T R,   [t]x E = s (t t^T - I) R
    #          => 2 cof(E) - sqrt(2) [t]x E = R
    #      and the sign flip E -> -E (DLT sign is arbitrary) gives the
    #      twisted-pair mate R_b = 2 cof(E) + sqrt(2) [t]x E; a wrong sign
    #      choice of t merely swaps the roles of R_a/R_b, so the standard 4
    #      candidates below still cover every case. Noise makes the formula's
    #      output only approximately orthogonal -- one Gram-Schmidt pass
    #      restores a proper rotation (r3 = r1 x r2 forces det +1).
    G = E @ jnp.swapaxes(E, -1, -2)
    eps = 1e-5 * jnp.trace(G, axis1=-2, axis2=-1)[..., None, None] + 1e-20
    Gs = G + eps * jnp.broadcast_to(jnp.eye(3, dtype=E.dtype), G.shape)
    Ginv = _inv3x3(Gs)
    tt = jnp.broadcast_to(
        jnp.array([0.5774, 0.5774, 0.5774], dtype=E.dtype), G.shape[:-1])
    for _ in range(3):
        tt = jnp.einsum("...ij,...j->...i", Ginv, tt)
        tt = tt / jnp.maximum(jnp.linalg.norm(tt, axis=-1, keepdims=True), 1e-30)
    zero = jnp.zeros_like(tt[..., 0])
    tx = jnp.stack([
        jnp.stack([zero, -tt[..., 2], tt[..., 1]], axis=-1),
        jnp.stack([tt[..., 2], zero, -tt[..., 0]], axis=-1),
        jnp.stack([-tt[..., 1], tt[..., 0], zero], axis=-1),
    ], axis=-2)
    En = E / jnp.maximum(jnp.linalg.norm(E, axis=(-2, -1), keepdims=True), 1e-30)
    # cof(En): cross products of En's column pairs give the cofactor columns.
    c0, c1, c2 = En[..., :, 0], En[..., :, 1], En[..., :, 2]
    cof = jnp.stack([jnp.cross(c1, c2), jnp.cross(c2, c0), jnp.cross(c0, c1)],
                    axis=-1)
    txE = tx @ En

    def _orthonormalize(R):
        r0 = R[..., 0, :]
        r0 = r0 / jnp.maximum(jnp.linalg.norm(r0, axis=-1, keepdims=True), 1e-30)
        r1 = R[..., 1, :] - jnp.sum(r0 * R[..., 1, :], axis=-1, keepdims=True) * r0
        r1 = r1 / jnp.maximum(jnp.linalg.norm(r1, axis=-1, keepdims=True), 1e-30)
        return jnp.stack([r0, r1, jnp.cross(r0, r1)], axis=-2)

    sqrt2 = jnp.asarray(1.4142135, E.dtype)
    Ra = _orthonormalize(2.0 * cof - sqrt2 * txE)
    Rb = _orthonormalize(2.0 * cof + sqrt2 * txE)

    def support_of(R, t):
        # Camera 1 at origin; camera 2 center in frame 1 is -R^T t; ray2 in
        # frame 1 is R^T r2. Positive-range triangulation on both rays.
        Rt = jnp.swapaxes(R, -1, -2)
        c2 = -(Rt @ t[..., None])[..., 0]
        r2_in_1 = jnp.einsum("...ij,...nj->...ni", Rt, rays2)
        tri = midpoint_triangulate(
            rays1, r2_in_1,
            jnp.zeros_like(c2)[..., None, :], c2[..., None, :],
            min_angle=1e-4, max_range=1e6, max_gap=1e6,
        )
        return jnp.sum(weights * tri.valid.astype(weights.dtype), axis=-1)

    cands_R = jnp.stack([Ra, Ra, Rb, Rb], axis=-3)
    cands_t = jnp.stack([tt, -tt, tt, -tt], axis=-2)
    supports = jnp.stack(
        [support_of(cands_R[..., i, :, :], cands_t[..., i, :]) for i in range(4)], axis=-1
    )
    best = jnp.argmax(supports, axis=-1)
    R = jnp.take_along_axis(cands_R, best[..., None, None, None].repeat(3, -2).repeat(3, -1), axis=-3)[..., 0, :, :]
    t = jnp.take_along_axis(cands_t, best[..., None, None].repeat(3, -1), axis=-2)[..., 0, :]
    return R, t, jnp.max(supports, axis=-1)
