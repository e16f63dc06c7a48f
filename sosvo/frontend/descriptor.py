"""Binary descriptors: BRIEF-style 256-bit intensity-pair comparisons.

JAX replacement for the reference's OpenCV C++ BRIEF/ORB descriptor
boundary (SURVEY.md C6: "oriented-BRIEF-style 256-bit binary descriptor via
gather of smoothed-intensity pairs"). The sampling pattern is a fixed random
set of point pairs in a patch (same idea as BRIEF's learned/ random pattern),
generated deterministically at import time, and the per-keypoint sampling is
ONE big gather over the smoothed panorama -- K x 256 x 2 samples fused by XLA.

Orientation steering (rBRIEF, the "oriented" in ORB) is available but off by
default: panoramas are gravity/axis aligned by construction (the rig's mirror
axis fixes "up"), so in-plane rotation between frames is bounded by roll,
which is small for the MAV platform [P2], and upright BRIEF is both cheaper
and more discriminative when rotation is absent. Set
`FrontendConfig.oriented=True` to steer: per-keypoint angle from the
intensity centroid of a radius-7 disk (ORB's IC_Angle), the sampling pattern
rotated by that angle before the gather -- the JAX equivalent of
OpenCV's steered-BRIEF lookup tables, except the rotation is exact instead of
quantized to 30 bins.

Bits are packed 32-per-uint32 into DESC_WORDS words for the Hamming matcher.
Columns wrap (azimuth); rows clamp.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from sosvo.frontend.detect import Keypoints, gaussian_smooth

NBITS = 256
WORDS = NBITS // 32


def _disk_offsets(radius: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """All integer (drow, dcol) offsets within `radius`, as two flat arrays."""
    rr, cc = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    keep = rr * rr + cc * cc <= radius * radius
    return rr[keep].astype(np.float32), cc[keep].astype(np.float32)


_DISK_DR, _DISK_DC = _disk_offsets()


def orientation(img: jnp.ndarray, kps: Keypoints) -> jnp.ndarray:
    """Per-keypoint patch orientation by intensity centroid (ORB IC_Angle).

    theta = atan2(m01, m10) over a radius-7 disk, with m10 = sum(dc * I) and
    m01 = sum(dr * I). One fused (K, |disk|) gather; columns wrap (azimuth),
    rows clamp. Returns (K,) float32 radians.
    """
    h, w = img.shape
    r = jnp.round(kps.rows[:, None] + jnp.asarray(_DISK_DR)[None, :]).astype(jnp.int32)
    c = jnp.round(kps.cols[:, None] + jnp.asarray(_DISK_DC)[None, :]).astype(jnp.int32)
    patch = img[jnp.clip(r, 0, h - 1), jnp.mod(c, w)]  # (K, |disk|)
    m10 = jnp.sum(patch * jnp.asarray(_DISK_DC)[None, :], axis=1)
    m01 = jnp.sum(patch * jnp.asarray(_DISK_DR)[None, :], axis=1)
    return jnp.arctan2(m01, m10)


def _make_pattern(patch: int = 24, seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Fixed random BRIEF pattern: two (NBITS, 2) float offsets, Gaussian-
    distributed within the patch (sigma = patch/5, BRIEF-G II)."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    a = np.clip(rng.normal(0.0, sigma, (NBITS, 2)), -patch / 2 + 1, patch / 2 - 1)
    b = np.clip(rng.normal(0.0, sigma, (NBITS, 2)), -patch / 2 + 1, patch / 2 - 1)
    return a.astype(np.float32), b.astype(np.float32)


_PAT_A, _PAT_B = _make_pattern()


def describe(
    pano: jnp.ndarray,
    kps: Keypoints,
    smoothed: jnp.ndarray | None = None,
    angles: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """(K, WORDS) uint32 packed descriptors at the keypoints.

    Args:
      pano: (H, W) panorama (used only if `smoothed` is None).
      kps: fixed-size keypoints (rows/cols may be subpixel; samples round).
      smoothed: optionally the pre-smoothed panorama (reuse the detector's).
      angles: optional (K,) patch orientations (radians); when given the
        sampling pattern is rotated per keypoint (steered BRIEF / rBRIEF).
    """
    img = gaussian_smooth(pano) if smoothed is None else smoothed
    h, w = img.shape
    pa = jnp.asarray(_PAT_A)  # (NBITS, 2) as (drow, dcol)
    pb = jnp.asarray(_PAT_B)

    if angles is not None:
        ca, sa = jnp.cos(angles)[:, None], jnp.sin(angles)[:, None]

    def sample(offsets):
        dr, dc = offsets[None, :, 0], offsets[None, :, 1]  # (1, NBITS)
        if angles is not None:
            # Rotate the pattern into the patch frame (x=col, y=row, y down):
            # same convention as ORB's steered BRIEF.
            dr, dc = sa * dc + ca * dr, ca * dc - sa * dr
        r = jnp.round(kps.rows[:, None] + dr).astype(jnp.int32)
        c = jnp.round(kps.cols[:, None] + dc).astype(jnp.int32)
        r = jnp.clip(r, 0, h - 1)
        c = jnp.mod(c, w)  # azimuth wrap
        return img[r, c]  # (K, NBITS)

    bits = (sample(pa) < sample(pb)).astype(jnp.uint32)  # (K, NBITS)
    k = bits.shape[0]
    grouped = bits.reshape(k, WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(grouped << shifts, axis=-1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# SIFT-style float descriptor (the reference's `cv2.SIFT_create` option)
# ---------------------------------------------------------------------------

SIFT_CELLS = 4      # spatial cells per side
SIFT_SPC = 4        # samples per cell per side -> 16x16 sample grid
SIFT_BINS = 8       # orientation bins
SIFT_DIM = SIFT_CELLS * SIFT_CELLS * SIFT_BINS  # 128
_SIFT_SIDE = SIFT_CELLS * SIFT_SPC              # 16
_SIFT_CLIP = 0.2    # standard SIFT histogram clipping


def _sift_grid() -> np.ndarray:
    """(S+2, S+2, 2) float sample offsets: 16x16 descriptor grid plus a
    one-sample halo on each side for central-difference gradients."""
    s = _SIFT_SIDE + 2
    ax = np.arange(s, dtype=np.float32) - (s - 1) / 2.0
    rr, cc = np.meshgrid(ax, ax, indexing="ij")
    return np.stack([rr, cc], axis=-1)


_SIFT_GRID = _sift_grid()
# Gaussian spatial weight over the 16x16 descriptor window (sigma = half side,
# as in Lowe's SIFT), evaluated at the inner grid samples.
_SIFT_W = np.exp(
    -(_SIFT_GRID[1:-1, 1:-1, 0] ** 2 + _SIFT_GRID[1:-1, 1:-1, 1] ** 2)
    / (2.0 * (_SIFT_SIDE / 2.0) ** 2)
).astype(np.float32)


def describe_sift(
    pano: jnp.ndarray,
    kps: Keypoints,
    smoothed: jnp.ndarray | None = None,
    angles: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """(K, 128) float32 SIFT-style descriptors at the keypoints.

    JAX equivalent of the reference's optional SIFT frontend (SURVEY.md
    C6 lists "ORB default; SIFT/AKAZE options"): 4x4 spatial cells x 8
    orientation bins of Gaussian-weighted gradient magnitude over a 16x16
    sample grid, trilinear in orientation, L2-normalized with the standard
    0.2 clip-and-renormalize. Everything is ONE fused gather of an 18x18
    per-keypoint patch plus dense vector math -- no scatter, no loops -- so it
    jits and fuses with the rest of the frontend.

    When `angles` is given the sample grid is rotated per keypoint; because
    gradients are taken by differencing along the rotated grid axes, they are
    natively expressed in the patch frame (rotation invariance without a
    separate orientation correction).
    """
    img = gaussian_smooth(pano) if smoothed is None else smoothed
    h, w = img.shape
    grid = jnp.asarray(_SIFT_GRID)  # (18, 18, 2)
    dr = grid[..., 0].reshape(-1)[None, :]  # (1, 324)
    dc = grid[..., 1].reshape(-1)[None, :]
    if angles is not None:
        ca, sa = jnp.cos(angles)[:, None], jnp.sin(angles)[:, None]
        dr, dc = sa * dc + ca * dr, ca * dc - sa * dr
    r = jnp.clip(jnp.round(kps.rows[:, None] + dr).astype(jnp.int32), 0, h - 1)
    c = jnp.mod(jnp.round(kps.cols[:, None] + dc).astype(jnp.int32), w)
    side = _SIFT_SIDE + 2
    patch = img[r, c].reshape(-1, side, side)  # (K, 18, 18)

    # Central differences along the (possibly rotated) grid axes = patch-frame
    # gradients. Inner 16x16 window only.
    gy = (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) * 0.5  # (K, 16, 16)
    gx = (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) * 0.5
    mag = jnp.sqrt(gx * gx + gy * gy + 1e-20) * jnp.asarray(_SIFT_W)[None]
    theta = jnp.arctan2(gy, gx)  # [-pi, pi]

    # Trilinear orientation binning: split each sample between its two
    # nearest orientation bins (one-hot matmul-free formulation).
    tb = (theta / (2.0 * jnp.pi) + 0.5) * SIFT_BINS  # [0, 8]
    b0 = jnp.floor(tb)
    f = tb - b0
    b0 = jnp.mod(b0.astype(jnp.int32), SIFT_BINS)
    b1 = jnp.mod(b0 + 1, SIFT_BINS)
    bins = jnp.arange(SIFT_BINS, dtype=jnp.int32)
    contrib = mag[..., None] * (
        (bins == b0[..., None]) * (1.0 - f[..., None])
        + (bins == b1[..., None]) * f[..., None]
    )  # (K, 16, 16, 8)

    k = contrib.shape[0]
    hist = contrib.reshape(
        k, SIFT_CELLS, SIFT_SPC, SIFT_CELLS, SIFT_SPC, SIFT_BINS
    ).sum(axis=(2, 4)).reshape(k, SIFT_DIM)

    # L2 normalize -> clip at 0.2 -> renormalize (illumination robustness).
    hist = hist / jnp.linalg.norm(hist, axis=1, keepdims=True).clip(1e-12)
    hist = jnp.minimum(hist, _SIFT_CLIP)
    return (hist / jnp.linalg.norm(hist, axis=1, keepdims=True).clip(1e-12)).astype(jnp.float32)
