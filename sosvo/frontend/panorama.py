"""Cylindrical panorama generation from the raw omnidirectional image.

JAX replacement for the reference's LUT + `cv2.remap` panorama stage
(SURVEY.md C5: per-view pixel LUT built once per calibration, then a C++
remap per frame). Here the LUT is built in JAX once per (rig, pano-geometry)
and the per-frame warp is a bilinear gather via
`jax.scipy.ndimage.map_coordinates` -- pure XLA, fuses into the jitted step.

Panorama geometry [P1]: rows sample elevation linearly in [min_el, max_el]
(top row = max elevation), columns sample azimuth uniformly over [-pi, pi).
Because the two views are coaxial, the SAME column in the top and bottom
panoramas corresponds to the SAME azimuth: epipolar curves become columns,
and stereo matching reduces to a per-column search. The panorama wraps
horizontally (azimuth is circular).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.sensor.model import ViewParams, project


class PanoGeometry(NamedTuple):
    """Static panorama geometry + the precomputed sampling LUT for one view.

    Besides the float (u, v) coords, the bilinear interpolation is fully
    precomputed at calibration time (SURVEY.md C5 "LUT build ... once").
    The LUT addresses 2x2 QUADS: the per-frame warp restructures the raw
    image into 4-wide quad rows (img[y,x], img[y,x+1], img[y+1,x],
    img[y+1,x+1]) in two horizontal phase tables (even/odd x0), and each
    pano pixel fetches its ENTIRE bilinear footprint with a SINGLE gather
    index (`idx_r0`) -- a quarter of the gather indices of the 4-corner
    flat-take warp. The layout was chosen where gathers cost per index
    regardless of fetch width; whether it still pays on the GPU is not
    measured yet.
    """

    height: int
    width: int
    min_elevation: float
    max_elevation: float
    lut_uv: jnp.ndarray   # (H, W, 2) raw-image (u, v) sample coords
    valid: jnp.ndarray    # (H, W) bool: LUT lands inside the view's annulus
    idx_r0: jnp.ndarray   # (H, W) int32 quad-table row of the 2x2 footprint
    fu: jnp.ndarray       # (H, W) f32 horizontal lerp fraction
    fv: jnp.ndarray       # (H, W) f32 vertical lerp fraction


def pano_ray(height: int, width: int, min_el: float, max_el: float,
             row: jnp.ndarray, col: jnp.ndarray) -> jnp.ndarray:
    """Unit ray (view frame) of a panorama pixel; row/col may be fractional."""
    az = (col + 0.5) / width * (2.0 * jnp.pi) - jnp.pi
    el = max_el - (row + 0.5) / height * (max_el - min_el)
    cos_el = jnp.cos(el)
    return jnp.stack([cos_el * jnp.cos(az), cos_el * jnp.sin(az), jnp.sin(el)], axis=-1)


def pano_azimuth(width: int, col: jnp.ndarray) -> jnp.ndarray:
    return (col + 0.5) / width * (2.0 * jnp.pi) - jnp.pi


def pano_elevation(height: int, min_el: float, max_el: float, row: jnp.ndarray) -> jnp.ndarray:
    return max_el - (row + 0.5) / height * (max_el - min_el)


def build_pano_geometry(view: ViewParams, height: int, width: int,
                        min_el: float | None = None, max_el: float | None = None,
                        image_height: int = 768, image_width: int = 768) -> PanoGeometry:
    """Build the sampling LUT mapping panorama pixels -> raw-image coords.

    Run once per calibration (SURVEY.md C5 "LUT build in JAX once"); the
    result is a pytree of device arrays closed over by the jitted frontend.
    `image_height/width` size the precomputed flat bilinear indices.
    """
    min_el = float(view.min_elevation) if min_el is None else min_el
    max_el = float(view.max_elevation) if max_el is None else max_el
    rows = jnp.arange(height, dtype=jnp.float32)
    cols = jnp.arange(width, dtype=jnp.float32)
    rr, cc = jnp.meshgrid(rows, cols, indexing="ij")
    rays = pano_ray(height, width, min_el, max_el, rr, cc)
    uv, ok = project(view, rays)

    # Precompute the bilinear sample: clamp to the image, flat corner indices.
    u = jnp.clip(uv[..., 0], 0.0, image_width - 1.001)
    v = jnp.clip(uv[..., 1], 0.0, image_height - 1.001)
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = u0.astype(jnp.int32)
    v0i = v0.astype(jnp.int32)
    # Quad-table addressing (see PanoGeometry docstring and warp_panorama):
    # even-phase quads (x0 = 2m) come first, odd-phase quads (x0 = 2m+1)
    # after; one idx_r0 entry addresses the whole 2x2 bilinear footprint of
    # the pano pixel in the per-frame quad tables.
    assert image_width % 2 == 0, "quad-table warp assumes an even image width"
    half = image_width // 2
    even = (u0i % 2) == 0
    m = jnp.where(even, u0i, u0i - 1) // 2
    base = jnp.where(even, 0, image_height * half)
    return PanoGeometry(
        height=height,
        width=width,
        min_elevation=min_el,
        max_elevation=max_el,
        lut_uv=uv,
        valid=ok,
        idx_r0=(base + v0i * half + m).astype(jnp.int32),
        fu=fu,
        fv=fv,
    )


def warp_panorama(image: jnp.ndarray, geom: PanoGeometry) -> jnp.ndarray:
    """Bilinear-sample the raw omni image into the panorama. (H, W) float32.

    Equivalent of the reference's `cv2.remap` call. All interpolation
    arithmetic is baked into the static LUT; the per-frame work is ONE quad
    gather + lerps. The image is restructured per frame into 2x2 QUAD rows (img[y,x], img[y,x+1], img[y+1,x], img[y+1,x+1]) in two
    horizontal phase tables; each pano pixel then fetches its full bilinear
    footprint with a SINGLE index (same `idx_r0` layout as the earlier
    pair-table scheme, which needed two indices: the y0 and y1 taps).
    The restructure itself is strided slices + one copy (~2.3 MB), which
    XLA streams at memory bandwidth.
    """
    q = jnp.take(_quad_tables(image), geom.idx_r0, axis=0)  # (H, W, 4)
    v0 = q[..., 0] * (1.0 - geom.fu) + q[..., 1] * geom.fu
    v1 = q[..., 2] * (1.0 - geom.fu) + q[..., 3] * geom.fu
    pano = v0 * (1.0 - geom.fv) + v1 * geom.fv
    return jnp.where(geom.valid, pano, 0.0)


def _quad_tables(image: jnp.ndarray) -> jnp.ndarray:
    """(h*w, 4) even+odd phase quad rows of the raw image (see warp docstring)."""
    # Rows shifted up by one: down[v] = image[v+1] (last row clamped, never
    # addressed: the LUT clamps v to <= h-2 + fv).
    down = jnp.concatenate([image[1:], image[-1:]], axis=0)
    # Horizontal +1 shifts for the odd x0 phase.
    shift = jnp.concatenate([image[:, 1:], image[:, -1:]], axis=1)
    sdown = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    even = jnp.stack([image[:, 0::2], image[:, 1::2],
                      down[:, 0::2], down[:, 1::2]], axis=-1)   # (h, w/2, 4)
    odd = jnp.stack([shift[:, 0::2], shift[:, 1::2],
                     sdown[:, 0::2], sdown[:, 1::2]], axis=-1)
    return jnp.concatenate([even.reshape(-1, 4), odd.reshape(-1, 4)])


# NOTE: a `warp_panorama_stacked` variant (quad tables built once, both
# views' footprints fetched with stacked (2, H, W) indices) forces the warp
# output to materialize instead of fusing into each view's smooth/detect
# consumers; two per-view warps fused into their own streams are kept (see
# image_frontend.extract_observations).
