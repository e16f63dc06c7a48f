"""Image frontend: raw omni image -> panoramas -> keypoints -> observations.

Composes the panorama warp (SURVEY.md C5), Harris detection (C6), BRIEF
description (C6) into the same fixed-size `FrameObservations` structure the
core VO pipeline consumes -- so observation-mode (c1) and image-mode (c2+)
share every downstream component. This whole function jits and fuses with the
per-frame step: the reference crosses three OpenCV C++ boundaries here per
frame (remap, detector, descriptor); we cross zero.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sosvo.frontend.descriptor import describe, describe_sift, orientation
from sosvo.frontend.detect import detect, gaussian_smooth
from sosvo.frontend.panorama import (PanoGeometry, build_pano_geometry,
                                     pano_ray, warp_panorama)
from sosvo.sensor.model import project
from sosvo.sensor.rig import OmnistereoRig
from sosvo.synth.scene import FrameObservations
from sosvo.utils.config import FrontendConfig


class FrontendLUTs(NamedTuple):
    """Per-view panorama geometries, built once per calibration."""

    top: PanoGeometry
    bottom: PanoGeometry


def build_frontend_luts(rig: OmnistereoRig, cfg: FrontendConfig) -> FrontendLUTs:
    # Use the stereo-overlap elevation band for BOTH panoramas so matching
    # stereo features see the same scene band (SURVEY.md C4).
    lo = float(jnp.maximum(rig.top.min_elevation, rig.bottom.min_elevation))
    hi = float(jnp.minimum(rig.top.max_elevation, rig.bottom.max_elevation))
    return FrontendLUTs(
        top=build_pano_geometry(rig.top, cfg.pano_height, cfg.pano_width, lo, hi,
                                image_height=rig.image_height,
                                image_width=rig.image_width),
        bottom=build_pano_geometry(rig.bottom, cfg.pano_height, cfg.pano_width, lo, hi,
                                   image_height=rig.image_height,
                                   image_width=rig.image_width),
    )


def extract_observations(
    rig: OmnistereoRig,
    luts: FrontendLUTs,
    cfg: FrontendConfig,
    image: jnp.ndarray,
) -> FrameObservations:
    """Full frontend for one raw omni image; fixed K slots per view."""
    k = cfg.max_features

    def halve(img: jnp.ndarray) -> jnp.ndarray:
        """Factor-2 average-pool downsample (pyramid octave)."""
        h, w = img.shape
        return img.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    def run_view_pano(pano, view, geom_valid, geom: PanoGeometry):
        """Detect/describe/lift one already-warped panorama.

        `geom_valid` is the view's (H, W) valid mask passed as a traced
        array (vmappable); the remaining PanoGeometry fields used here are
        STATIC scalars shared by both views (`build_frontend_luts` gives
        both panoramas the common stereo-overlap elevation band), which is
        what makes the two-view vmap below legal.
        """
        # K feature slots split across pyramid octaves (n_scales=1: all at
        # full resolution). Coarse-level keypoints are detected AND described
        # on the downsampled panorama (scale invariance, like ORB's per-level
        # extraction), then their coordinates map back to full resolution for
        # ray lifting.
        ks = [k - (cfg.n_scales - 1) * (k // cfg.n_scales)] + \
             [k // cfg.n_scales] * (cfg.n_scales - 1)
        rows_l, cols_l, resp_l, ok_l, desc_l = [], [], [], [], []
        lvl_img = pano
        for lvl in range(cfg.n_scales):
            if lvl > 0:
                lvl_img = halve(lvl_img)
            smoothed = gaussian_smooth(lvl_img)
            kps = detect(
                lvl_img,
                ks[lvl],
                threshold=cfg.detect_threshold * 1e-7,
                nms_radius=cfg.nms_grid,
                border_rows=cfg.descriptor_patch // 2 + 2,
                detector=cfg.detector,
                fast_threshold=cfg.fast_threshold,
            )
            angles = orientation(smoothed, kps) if cfg.oriented else None
            describe_fn = describe_sift if cfg.descriptor == "sift" else describe
            desc_l.append(describe_fn(lvl_img, kps, smoothed=smoothed, angles=angles))
            s = float(2 ** lvl)
            # Center-of-pool alignment: pooled cell i covers full-res
            # [s*i, s*i + s), whose center is s*i + (s-1)/2.
            rows_l.append(kps.rows * s + (s - 1.0) / 2.0)
            cols_l.append(kps.cols * s + (s - 1.0) / 2.0)
            resp_l.append(kps.response)
            ok_l.append(kps.valid)
        rows = jnp.concatenate(rows_l)
        cols = jnp.concatenate(cols_l)
        valid = jnp.concatenate(ok_l)
        desc = jnp.concatenate(desc_l, axis=0)
        rays = pano_ray(geom.height, geom.width, geom.min_elevation,
                        geom.max_elevation, rows, cols)
        uv, _ = project(view, rays)
        # Keypoints whose pano cell has no raw-image support are invalid.
        lut_ok = geom_valid[rows.astype(jnp.int32), cols.astype(jnp.int32)]
        return uv, rays, desc, valid & lut_ok

    def run_view(view, geom: PanoGeometry):
        pano = warp_panorama(image, geom)
        if cfg.descriptor == "akaze":
            # AKAZE option (SURVEY.md C6): nonlinear scale space + Hessian
            # detection + M-LDB bits. Its own diffusion levels subsume the
            # linear pyramid, so n_scales is ignored on this path; the packed
            # uint32 output feeds the same Hamming matcher as BRIEF.
            from sosvo.frontend.akaze import extract_akaze

            kps, desc = extract_akaze(pano, k, patch=cfg.descriptor_patch,
                                      threshold=cfg.detect_threshold * 1e-2,
                                      nms_radius=cfg.nms_grid)
            rays = pano_ray(geom.height, geom.width, geom.min_elevation,
                            geom.max_elevation, kps.rows, kps.cols)
            uv, _ = project(view, rays)
            lut_ok = geom.valid[kps.rows.astype(jnp.int32),
                                kps.cols.astype(jnp.int32)]
            return uv, rays, desc, kps.valid & lut_ok
        raise AssertionError("run_view is the akaze-only path")

    if cfg.descriptor == "akaze":
        uv_t, ray_t, desc_t, ok_t = run_view(rig.top, luts.top)
        uv_b, ray_b, desc_b, ok_b = run_view(rig.bottom, luts.bottom)
    else:
        # SEQUENTIAL per-view streams, each warp fused with its consumers.
        # Two restructures lost to this layout on the previous accelerator
        # and are not measured on the GPU yet: both views vmapped through
        # one detect/describe program (batched top-k/gather lowerings), and
        # a shared-quad stacked warp (it forces materialization between
        # warp and smooth).
        uv_t, ray_t, desc_t, ok_t = run_view_pano(
            warp_panorama(image, luts.top), rig.top, luts.top.valid,
            luts.top)
        uv_b, ray_b, desc_b, ok_b = run_view_pano(
            warp_panorama(image, luts.bottom), rig.bottom, luts.bottom.valid,
            luts.bottom)
    return FrameObservations(
        uv_top=uv_t,
        uv_bottom=uv_b,
        ray_top=ray_t,
        ray_bottom=ray_b,
        desc_top=desc_t,
        desc_bottom=desc_b,
        valid_top=ok_t,
        valid_bottom=ok_b,
        lm_id=jnp.full((k,), -1, jnp.int32),
    )
