"""Feature detection on panoramas: Harris corners + NMS + fixed top-K.

JAX replacement for the reference's OpenCV C++ detector boundary
(SURVEY.md C6: ORB = FAST + Harris ranking + BRIEF; here the detector is a
Harris corner response -- the ranking ORB itself uses -- computed as a few
separable convolutions, entirely fusable by XLA). The key JIT-ification move
(SURVEY.md SS7 "hard parts #1") is FIXED-SIZE output: exactly K keypoint
slots with a validity mask, selected by `lax.top_k` over the NMS'd response
map. No dynamic shapes anywhere.

The panorama wraps horizontally (azimuth), so convolutions and NMS use
circular padding along columns; rows are zero-padded.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Keypoints(NamedTuple):
    rows: jnp.ndarray      # (K,) float32 subpixel row
    cols: jnp.ndarray      # (K,) float32 subpixel col
    response: jnp.ndarray  # (K,) float32 Harris response
    valid: jnp.ndarray     # (K,) bool


def _wrap_pad(img: jnp.ndarray, pad: int) -> jnp.ndarray:
    """Pad rows with edge values, columns circularly (azimuth wrap)."""
    img = jnp.concatenate([img[:, -pad:], img, img[:, :pad]], axis=1)
    img = jnp.concatenate([img[:1].repeat(pad, 0), img, img[-1:].repeat(pad, 0)], axis=0)
    return img


def _conv2_sep(img: jnp.ndarray, kr: jnp.ndarray, kc: jnp.ndarray) -> jnp.ndarray:
    """Separable 2D convolution with wrap-padded borders.

    Implemented as static-slice shift-and-add (taps unrolled at trace time),
    NOT `lax.conv`: a conv path built for many-channel work pays layout
    overhead that dwarfs a 5-tap single-channel filter. Shift-add is pure
    elementwise work that XLA fuses into one pass over the panorama
    (~0.3 MB).
    """
    pr, pc = kr.shape[0] // 2, kc.shape[0] // 2
    h, w = img.shape
    x = _wrap_pad(img, max(pr, pc, 1)) if (pr or pc) else img
    # Row pass: weighted sum of vertically shifted slices.
    off = max(pr, pc, 1)
    if pr:
        x = sum(float(kr[i]) * jax.lax.slice_in_dim(x, off - pr + i, off - pr + i + h, axis=0)
                for i in range(kr.shape[0]))
    else:
        x = jax.lax.slice_in_dim(x, off, off + h, axis=0)
    # Column pass: weighted sum of horizontally shifted slices.
    if pc:
        x = sum(float(kc[j]) * jax.lax.slice_in_dim(x, off - pc + j, off - pc + j + w, axis=1)
                for j in range(kc.shape[0]))
    else:
        x = jax.lax.slice_in_dim(x, off, off + w, axis=1)
    return x


# Tap weights as NUMPY arrays: they are unrolled into python-float
# multiplies at trace time (_conv2_sep), and jnp module constants become
# tracers under jit in jax>=0.9, which would break that.
_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_DERIV = np.array([-0.5, 0.0, 0.5], np.float32)
_ONE = np.array([1.0], np.float32)


def gaussian_smooth(img: jnp.ndarray) -> jnp.ndarray:
    return _conv2_sep(img, _GAUSS5, _GAUSS5)


def harris_response(img: jnp.ndarray, k: float = 0.04) -> jnp.ndarray:
    """Harris corner response with Gaussian-windowed structure tensor."""
    ix = _conv2_sep(img, _ONE, _DERIV)
    iy = _conv2_sep(img, _DERIV, _ONE)
    sxx = _conv2_sep(ix * ix, _GAUSS5, _GAUSS5)
    syy = _conv2_sep(iy * iy, _GAUSS5, _GAUSS5)
    sxy = _conv2_sep(ix * iy, _GAUSS5, _GAUSS5)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def nms_local_max(resp: jnp.ndarray, radius: int = 1) -> jnp.ndarray:
    """Keep only strict local maxima in a (2r+1)^2 window (wrap columns).

    Max-pooling is separable: a 1D row window then a 1D column window give
    the same (2r+1)^2 max with 2(2r+1) comparisons instead of (2r+1)^2.
    """
    pad = radius
    x = _wrap_pad(resp, pad)
    win = 2 * radius + 1
    mx = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (win, 1), (1, 1), "VALID")
    mx = jax.lax.reduce_window(mx, -jnp.inf, jax.lax.max, (1, win), (1, 1), "VALID")
    return jnp.where(resp >= mx, resp, -jnp.inf)


# Bresenham circle of radius 3 (FAST-16 ring), in (drow, dcol) order going
# clockwise from the top of the circle -- the order matters for the
# contiguous-arc test, not the starting point.
_FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_mask(img: jnp.ndarray, threshold: float = 0.04, arc: int = 9) -> jnp.ndarray:
    """FAST-N segment-test corner mask (the ORB detector's first stage).

    A pixel is a corner if `arc` CONTIGUOUS pixels on the 16-point Bresenham
    ring are all brighter than center+t or all darker than center-t. The
    reference reaches this through OpenCV's C++ `FAST_9_16` inside
    `cv2.ORB_create` (SURVEY.md C6); here the 16 ring views are 16 statically
    shifted slices of the wrap-padded panorama and the circular-run test is a
    fixed AND-reduction -- one fused elementwise XLA computation, no
    data-dependent control flow.

    Args:
      img: (H, W) float panorama (any brightness scale; `threshold` is in the
        same units).
      threshold: center-vs-ring intensity margin t.
      arc: run length N of the segment test (9 = FAST-9, ORB's default).

    Returns:
      (H, W) bool corner mask.
    """
    h, w = img.shape
    pad = 3
    x = _wrap_pad(img, pad)
    ring = jnp.stack(
        [x[pad + dr : pad + dr + h, pad + dc : pad + dc + w] for dr, dc in _FAST_RING],
        axis=0,
    )  # (16, H, W)
    bright = ring > img[None] + threshold
    dark = ring < img[None] - threshold

    def has_run(flags):
        # Circular run of length `arc`: AND of `arc` consecutive rotations,
        # then OR over the 16 starting positions.
        run = flags
        for j in range(1, arc):
            run = run & jnp.roll(flags, -j, axis=0)
        return jnp.any(run, axis=0)

    return has_run(bright) | has_run(dark)


def detect(
    pano: jnp.ndarray,
    max_features: int,
    threshold: float = 1e-6,
    nms_radius: int = 1,
    border_rows: int = 12,
    detector: str = "harris",
    fast_threshold: float = 0.04,
    exact_topk: bool = False,
) -> Keypoints:
    """Detect up to K Harris corners; fixed-size output with validity mask.

    Args:
      pano: (H, W) float32 panorama.
      max_features: K, the fixed slot count.
      threshold: minimum Harris response (relative to the image's own
        response scale: threshold * max_response, making it exposure
        invariant).
      border_rows: rows excluded at top/bottom (descriptor patch must fit;
        columns wrap so no horizontal border is needed).
      detector: "harris" (default) or "fast" -- FAST-9 segment test gating
        with Harris ranking of the surviving pixels, which is exactly ORB's
        detector composition (FAST candidates ranked by Harris score).
      fast_threshold: FAST center-vs-ring margin (only used for "fast").
    """
    h, w = pano.shape
    smoothed = gaussian_smooth(pano)
    resp_raw = harris_response(smoothed)  # ungated: used for subpixel fit
    if detector == "fast":
        resp_sel = jnp.where(fast_mask(smoothed, fast_threshold), resp_raw, -jnp.inf)
    elif detector == "harris":
        resp_sel = resp_raw
    else:
        raise ValueError(f"unknown detector {detector!r}")
    resp = nms_local_max(resp_sel, nms_radius)
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    in_band = (row_ids >= border_rows) & (row_ids < h - border_rows)
    resp = jnp.where(in_band, resp, -jnp.inf)

    flat = resp.reshape(-1)
    # `approx_max_k` at recall 0.99 by default: where a backend lowers it to
    # an approximate kernel, the ~1% it may drop are marginal responses at
    # the K-th-corner boundary (ATE across the image-mode suite is
    # unchanged); on the GPU XLA lowers it to an exact top-k. Whether it
    # or `lax.top_k` is faster on the GPU is not measured yet.
    # `exact_topk=True` forces the exact selection (debug/parity).
    if exact_topk:
        vals, idx = jax.lax.top_k(flat, max_features)
    else:
        vals, idx = jax.lax.approx_max_k(flat, max_features,
                                         recall_target=0.99)
    r_i = (idx // w).astype(jnp.int32)
    c_i = (idx % w).astype(jnp.int32)
    scale = jnp.maximum(jnp.max(vals), 1e-12)
    valid = vals > threshold * scale

    # Subpixel refinement: 1D quadratic fit through the response along each
    # axis. A raw grid maximum quantizes the bearing to one pano cell
    # (2*pi/W rad of azimuth), which dominates the whole pipeline's geometric
    # error budget in image mode; the parabola cuts it ~5-10x.
    def refined(delta_axis):
        if delta_axis == 0:
            m = resp_raw[jnp.clip(r_i - 1, 0, h - 1), c_i]
            p = resp_raw[jnp.clip(r_i + 1, 0, h - 1), c_i]
        else:
            m = resp_raw[r_i, jnp.mod(c_i - 1, w)]
            p = resp_raw[r_i, jnp.mod(c_i + 1, w)]
        c0 = resp_raw[r_i, c_i]
        denom = m - 2.0 * c0 + p
        off = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (m - p) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    rows = r_i.astype(jnp.float32) + refined(0)
    cols = c_i.astype(jnp.float32) + refined(1)
    return Keypoints(rows=rows, cols=cols, response=vals, valid=valid)
