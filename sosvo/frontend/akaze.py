"""AKAZE-style features: nonlinear scale space + Hessian detection + M-LDB.

Completes the reference's descriptor option set (SURVEY.md C6: "ORB default;
SIFT/AKAZE options" via OpenCV's C++ `cv2.AKAZE_create`). Fixed-shape JAX design:

- **Nonlinear scale space**: Perona-Malik g2 diffusion ("edge-stopping":
  conductivity g = 1 / (1 + |grad I|^2 / k^2) suppresses smoothing across
  edges), evolved with fixed explicit steps -- a stack of shift-and-add
  stencil passes that XLA fuses, no data-dependent control flow. The
  contrast parameter k is the 70th percentile of the gradient magnitude,
  AKAZE's own heuristic, computed as one quantile per frame. This replaces
  AKAZE's FED (fast explicit diffusion) cycles with a fixed step count: same
  diffusion PDE, deterministic cost, jit-friendly.
- **Detector**: scale-normalized determinant-of-Hessian response per
  diffusion level, max-reduced across levels (recording the argmax level per
  pixel), then the shared wrap-aware NMS + top-K + subpixel machinery.
- **Descriptor**: M-LDB (modified local difference binary) -- compare mean
  (intensity, dx, dy) between cells of a grid around the keypoint on the
  keypoint's OWN diffusion level; 256 fixed channel-consistent cell pairs
  packed to 8 uint32 words, so the Hamming matcher (C7) and everything
  downstream are unchanged. Sampling is one fused (K, cells x taps) gather,
  like the BRIEF path.

Upright by default for the same reason as BRIEF (gravity-aligned panoramas);
columns wrap (azimuth), rows clamp.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from sosvo.frontend.detect import (
    Keypoints, _conv2_sep, _wrap_pad, _DERIV, _GAUSS5, _ONE,
    gaussian_smooth, nms_local_max,
)

NBITS = 256
WORDS = NBITS // 32
N_LEVELS = 4          # diffusion levels (evolution snapshots)
STEPS_PER_LEVEL = 6   # explicit diffusion steps between snapshots
DT = 0.2              # explicit-scheme step (stable for dt <= 0.25 in 2D)
GRID = 4              # M-LDB cell grid (GRID x GRID cells)
TAPS = 3              # per-cell mean estimated from TAPS x TAPS samples


def _grad(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    gx = _conv2_sep(img, _ONE, _DERIV)
    gy = _conv2_sep(img, _DERIV, _ONE)
    return gx, gy


def contrast_k(img: jnp.ndarray, q: float = 0.7) -> jnp.ndarray:
    """AKAZE contrast factor: the q-quantile of the gradient magnitude."""
    gx, gy = _grad(gaussian_smooth(img))
    mag = jnp.sqrt(gx * gx + gy * gy)
    return jnp.maximum(jnp.quantile(mag.reshape(-1), q), 1e-6)


def _diffusion_step(img: jnp.ndarray, k2: jnp.ndarray) -> jnp.ndarray:
    """One explicit Perona-Malik step: I += DT * div(g(|grad I|) grad I).

    Conductivities live on half-grid faces (standard 4-neighbor explicit
    scheme): flux through each face = g_face * finite difference, with g
    averaged onto the face. Columns wrap (azimuth), rows clamp (Neumann).
    """
    x = _wrap_pad(img, 1)
    h, w = img.shape
    c = x[1:h + 1, 1:w + 1]
    n = x[0:h, 1:w + 1]
    s = x[2:h + 2, 1:w + 1]
    e = x[1:h + 1, 2:w + 2]
    we = x[1:h + 1, 0:w]
    gx, gy = _grad(img)
    g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
    gp = _wrap_pad(g, 1)
    gn = 0.5 * (g + gp[0:h, 1:w + 1])
    gs = 0.5 * (g + gp[2:h + 2, 1:w + 1])
    ge = 0.5 * (g + gp[1:h + 1, 2:w + 2])
    gw = 0.5 * (g + gp[1:h + 1, 0:w])
    return img + DT * (gn * (n - c) + gs * (s - c) + ge * (e - c) + gw * (we - c))


def nonlinear_scale_space(img: jnp.ndarray, n_levels: int = N_LEVELS,
                          steps: int = STEPS_PER_LEVEL) -> jnp.ndarray:
    """(n_levels, H, W) diffusion snapshots; level 0 is lightly smoothed."""
    base = gaussian_smooth(img)
    k = contrast_k(img)
    k2 = k * k

    def evolve(carry, _):
        x = carry
        for _ in range(steps):
            x = _diffusion_step(x, k2)
        return x, x

    _, space = jax.lax.scan(evolve, base, None, length=n_levels - 1)
    return jnp.concatenate([base[None], space], axis=0)


def hessian_response(space: jnp.ndarray) -> jnp.ndarray:
    """(n_levels, H, W) scale-normalized det-of-Hessian responses.

    Evolution time grows linearly with level here (fixed steps/level), so the
    effective sigma^2 ~ level; det(H) is normalized by sigma^4 ~ (level+1)^2.
    """
    def one(lvl_img, weight):
        lxx = _conv2_sep(_conv2_sep(lvl_img, _ONE, _DERIV), _ONE, _DERIV)
        lyy = _conv2_sep(_conv2_sep(lvl_img, _DERIV, _ONE), _DERIV, _ONE)
        lxy = _conv2_sep(_conv2_sep(lvl_img, _DERIV, _ONE), _ONE, _DERIV)
        return weight * (lxx * lyy - lxy * lxy)

    n = space.shape[0]
    weights = (jnp.arange(n, dtype=space.dtype) + 1.0) ** 2
    return jax.vmap(one)(space, weights)


class AkazeKeypoints(NamedTuple):
    kps: Keypoints            # fixed-K rows/cols/response/valid
    level: jnp.ndarray        # (K,) int32 diffusion level of each keypoint


def detect_akaze(pano: jnp.ndarray, max_features: int,
                 threshold: float = 1e-4, nms_radius: int = 1,
                 border_rows: int = 12,
                 n_levels: int = N_LEVELS) -> tuple[AkazeKeypoints, jnp.ndarray]:
    """Top-K det-of-Hessian extrema over the nonlinear scale space.

    Returns the keypoints (+ per-keypoint level) and the scale space itself
    (so the descriptor samples the same diffusion images).
    """
    h, w = pano.shape
    space = nonlinear_scale_space(pano, n_levels)
    resp_l = hessian_response(space)                    # (L, H, W)
    resp = jnp.max(resp_l, axis=0)
    lvl_of = jnp.argmax(resp_l, axis=0).astype(jnp.int32)

    resp_nms = nms_local_max(resp, nms_radius)
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    in_band = (row_ids >= border_rows) & (row_ids < h - border_rows)
    resp_nms = jnp.where(in_band, resp_nms, -jnp.inf)

    # approx_max_k as in detect.py's detection top-k (on the GPU XLA lowers
    # it to an exact top-k).
    vals, idx = jax.lax.approx_max_k(resp_nms.reshape(-1), max_features,
                                     recall_target=0.99)
    r_i = (idx // w).astype(jnp.int32)
    c_i = (idx % w).astype(jnp.int32)
    scale = jnp.maximum(jnp.max(vals), 1e-12)
    valid = vals > threshold * scale

    # Subpixel parabola along each axis on the max-reduced response.
    def refined(axis):
        if axis == 0:
            m = resp[jnp.clip(r_i - 1, 0, h - 1), c_i]
            p = resp[jnp.clip(r_i + 1, 0, h - 1), c_i]
        else:
            m = resp[r_i, jnp.mod(c_i - 1, w)]
            p = resp[r_i, jnp.mod(c_i + 1, w)]
        c0 = resp[r_i, c_i]
        denom = m - 2.0 * c0 + p
        off = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (m - p) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    kps = Keypoints(rows=r_i.astype(jnp.float32) + refined(0),
                    cols=c_i.astype(jnp.float32) + refined(1),
                    response=vals, valid=valid)
    return AkazeKeypoints(kps=kps, level=lvl_of[r_i, c_i]), space


def _mldb_pairs(n_cells: int = GRID * GRID, n_bits: int = NBITS,
                seed: int = 11) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed channel-consistent cell pairs: (bit -> cell_a, cell_b, channel).

    All C(16,2)=120 cell pairs exist per channel (I, dx, dy) = 360 candidate
    bits; a fixed seeded permutation selects 256 -- deterministic at import,
    like the BRIEF pattern.
    """
    pairs = [(a, b, ch) for ch in range(3)
             for a in range(n_cells) for b in range(a + 1, n_cells)]
    rng = np.random.default_rng(seed)
    sel = rng.permutation(len(pairs))[:n_bits]
    arr = np.array([pairs[i] for i in sel], np.int32)
    return arr[:, 0], arr[:, 1], arr[:, 2]


_PAIR_A, _PAIR_B, _PAIR_CH = _mldb_pairs()


def describe_mldb(space: jnp.ndarray, ak: AkazeKeypoints,
                  patch: int = 24) -> jnp.ndarray:
    """(K, WORDS) uint32 packed M-LDB descriptors.

    Per keypoint: GRID x GRID cells over a patch on the keypoint's own
    diffusion level; per cell the mean intensity and mean dx/dy from a
    TAPS x TAPS sample grid (one fused gather of K x cells x taps^2 triples);
    bits compare cell means of the same channel across the fixed pair set.
    """
    n_lvl, h, w = space.shape
    k = ak.kps.rows.shape[0]
    cell = patch / GRID
    # Cell-center offsets + within-cell tap offsets (static, numpy).
    cidx = (np.arange(GRID, dtype=np.float32) + 0.5) * cell - patch / 2.0
    crr, ccc = np.meshgrid(cidx, cidx, indexing="ij")
    centers = np.stack([crr.reshape(-1), ccc.reshape(-1)], -1)   # (cells, 2)
    t = (np.arange(TAPS, dtype=np.float32) - (TAPS - 1) / 2.0) * (cell / TAPS)
    trr, tcc = np.meshgrid(t, t, indexing="ij")
    taps = np.stack([trr.reshape(-1), tcc.reshape(-1)], -1)      # (taps^2, 2)
    off = (centers[:, None, :] + taps[None, :, :]).reshape(-1, 2)  # (S, 2)

    dr = jnp.asarray(off[:, 0])[None, :]                          # (1, S)
    dc = jnp.asarray(off[:, 1])[None, :]
    r = jnp.round(ak.kps.rows[:, None] + dr).astype(jnp.int32)
    c = jnp.round(ak.kps.cols[:, None] + dc).astype(jnp.int32)
    r = jnp.clip(r, 0, h - 1)
    c = jnp.mod(c, w)
    flat_rc = r * w + c                                           # (K, S)
    # Add the per-keypoint level as the leading index of the flattened space.
    flat = (ak.level[:, None] * (h * w) + flat_rc).reshape(-1)

    gx_s = jax.vmap(lambda im: _conv2_sep(im, _ONE, _DERIV))(space)
    gy_s = jax.vmap(lambda im: _conv2_sep(im, _DERIV, _ONE))(space)
    vals = jnp.stack([space.reshape(-1)[flat],
                      gx_s.reshape(-1)[flat],
                      gy_s.reshape(-1)[flat]], axis=-1)           # (K*S, 3)
    vals = vals.reshape(k, GRID * GRID, TAPS * TAPS, 3)
    cells = jnp.mean(vals, axis=2)                                # (K, cells, 3)

    a = cells[:, jnp.asarray(_PAIR_A), jnp.asarray(_PAIR_CH)]     # (K, NBITS)
    b = cells[:, jnp.asarray(_PAIR_B), jnp.asarray(_PAIR_CH)]
    bits = (a > b).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits.reshape(k, WORDS, 32) << shifts[None, None, :], axis=-1)


def extract_akaze(pano: jnp.ndarray, max_features: int, patch: int = 24,
                  threshold: float = 1e-4, nms_radius: int = 1,
                  n_levels: int = N_LEVELS):
    """(kps, desc): the AKAZE option's drop-in for detect+describe."""
    border = patch // 2 + 2
    ak, space = detect_akaze(pano, max_features, threshold=threshold,
                             nms_radius=nms_radius, border_rows=border,
                             n_levels=n_levels)
    desc = describe_mldb(space, ak, patch=patch)
    return ak.kps, desc
