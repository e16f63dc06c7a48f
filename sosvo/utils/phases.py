"""Per-phase timing breakdown of the VO step (SURVEY.md section 5.1).

Times each pipeline stage as its own jitted function on the live backend --
panorama warp, detect+describe, stereo match, triangulation, temporal match,
RANSAC, refine, window BA -- so regressions localize to a phase.

Run:  python -m sosvo.utils.phases [--k 512] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json


def phase_breakdown(k: int = 512, n_landmarks: int = 4096, reps: int = 5) -> dict:
    """Amortized per-phase breakdown of the observation-mode VO step.

    Every phase is looped `inner` times INSIDE one dispatch with a vanishing
    loop-carried dependency, so the per-dispatch host overhead does not mask
    the 10-300 us phases here.
    """
    import functools

    import jax
    import jax.numpy as jnp

    from sosvo.backend.refine import refine_pose_bearings
    from sosvo.geometry.ransac import ransac_rigid
    from sosvo.geometry.triangulate import midpoint_triangulate
    from sosvo.sensor.model import viewpoint
    from sosvo.sensor.rig import default_rig
    from sosvo.synth.scene import make_scene, observe_frame
    from sosvo.utils.config import PipelineConfig
    from sosvo.utils.profiling import time_amortized
    from sosvo.vo.pipeline import _match, azimuth_of, step
    from sosvo.vo.state import init_track_state

    rig = default_rig()
    cfg = PipelineConfig()
    scene = make_scene(jax.random.PRNGKey(0), n_frames=3, n_landmarks=n_landmarks)
    o0 = observe_frame(rig, scene, jnp.asarray(1), k, jax.random.PRNGKey(1),
                       pixel_noise=0.3)
    o1 = observe_frame(rig, scene, jnp.asarray(2), k, jax.random.PRNGKey(2),
                       pixel_noise=0.3)

    times = {}

    def timed_loop(body, carry0, inner):
        """Median per-iteration seconds of `carry = body(carry)` in-device."""
        import statistics
        import time as _time

        loop = jax.jit(lambda c: jax.lax.fori_loop(0, inner, lambda _, c: body(c),
                                                   c))
        jax.block_until_ready(loop(carry0))
        ts = []
        for _ in range(reps):
            t0 = _time.perf_counter()
            jax.block_until_ready(loop(carry0))
            ts.append(_time.perf_counter() - t0)
        return statistics.median(ts) / inner

    # Matching consumes uint32 descriptors (no float input to perturb), so
    # the loop dependency is injected through the azimuth-band penalty for
    # the stereo variant and through a provably-zero-at-runtime descriptor
    # XOR for the unbanded temporal variant.
    az0, az0b = azimuth_of(o0.ray_top), azimuth_of(o0.ray_bottom)

    def stereo_body(az):
        m = _match(cfg, o0.desc_top, o0.desc_bottom, o0.valid_top, o0.valid_bottom,
                   az_a=az, az_b=az0b, band=cfg.frontend.stereo_band_rad)
        return az + jnp.sum(m.dist) * jnp.float32(1e-38)

    times["stereo_match"] = timed_loop(stereo_body, az0, inner=1024)
    m = _match(cfg, o0.desc_top, o0.desc_bottom, o0.valid_top, o0.valid_bottom,
               az_a=az0, az_b=az0b, band=cfg.frontend.stereo_band_rad)

    f_tri = functools.partial(midpoint_triangulate, c_top=viewpoint(rig.top),
                              c_bottom=viewpoint(rig.bottom))
    times["triangulate"] = time_amortized(
        lambda rt: f_tri(rt, o0.ray_bottom[m.idx_b]), o0.ray_top,
        inner=1024, n=reps)
    tri = f_tri(o0.ray_top, o0.ray_bottom[m.idx_b])

    def temporal_body(c):
        # (c > 1e30) is always 0 at runtime but data-dependent, so the XOR'd
        # descriptors defeat loop-invariant hoisting at negligible cost.
        d1 = o0.desc_top ^ (c > jnp.float32(1e30)).astype(jnp.uint32)
        tm_i = _match(cfg, d1, o1.desc_top, o0.valid_top, o1.valid_top)
        return c + jnp.sum(tm_i.dist) * jnp.float32(1e-38)

    times["temporal_match"] = timed_loop(temporal_body, jnp.float32(0.0), inner=1024)
    tm = _match(cfg, o0.desc_top, o1.desc_top, o0.valid_top, o1.valid_top)

    valid = m.valid & tri.valid & tm.valid
    times["ransac_rigid"] = time_amortized(
        lambda pts: ransac_rigid(jax.random.PRNGKey(3), pts, tri.points[tm.idx_b],
                                 valid, rays_curr=o1.ray_top[tm.idx_b],
                                 n_hyps=cfg.ransac.n_hyps),
        tri.points, inner=256, n=reps)
    rr = ransac_rigid(jax.random.PRNGKey(3), tri.points, tri.points[tm.idx_b],
                      valid, rays_curr=o1.ray_top[tm.idx_b],
                      n_hyps=cfg.ransac.n_hyps)

    times["refine"] = time_amortized(
        lambda T: refine_pose_bearings(T, tri.points, o1.ray_top[tm.idx_b],
                                       rr.inliers.astype(jnp.float32),
                                       iters=cfg.refine_iters),
        rr.model, inner=512, n=reps)

    from sosvo.geometry.ransac import ransac_essential

    times["ransac_essential"] = time_amortized(
        lambda r0: ransac_essential(jax.random.PRNGKey(5), r0,
                                    o1.ray_top[tm.idx_b], valid,
                                    n_hyps=cfg.ransac.n_hyps)[0].model,
        o0.ray_top, inner=256, n=reps)

    st = init_track_state(k, jax.random.PRNGKey(4))
    # Note: a fresh TrackState has no previous frame, so the rigid solve
    # fails and the lazy essential gate RUNS every rep -- this row is the
    # WORST-CASE frame (gate on), deliberately: it bounds the slowest
    # legitimate frame, while bench.py's replay rate reflects the typical
    # (gate-skipped) frame.
    times["full_step"] = time_amortized(
        lambda s: step(rig, cfg, s, o0)[0], st, inner=128, n=reps)

    return {
        "device": str(jax.devices()[0]),
        "k": k,
        "phases_ms": {n: round(t * 1e3, 4) for n, t in times.items()},
        "note": ("amortized in-device per-phase times (fori_loop/scan inside "
                 "one dispatch, divided by iteration count); phases sum to "
                 "less than full_step, which adds scoring/bookkeeping glue"),
    }


def image_phase_breakdown(image_size: int = 768, k: int = 384, reps: int = 5,
                          inner: int = 64, cfg=None) -> dict:
    """Amortized per-phase timing of the IMAGE-mode frontend (config c2 path).

    Each phase runs `inner` times inside one jitted scan (see
    `profiling.time_amortized`) so dispatch overhead does not drown the
    kernels.
    """
    import jax
    import jax.numpy as jnp

    from sosvo.frontend.descriptor import describe, describe_sift
    from sosvo.frontend.detect import detect, gaussian_smooth
    from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
    from sosvo.sensor.rig import default_rig
    from sosvo.synth.render import RoomScene, render_frame
    from sosvo.synth.scene import make_trajectory
    from sosvo.utils.config import FrontendConfig
    from sosvo.utils.profiling import time_amortized

    rig = default_rig(image_size=image_size)
    fe = cfg or FrontendConfig(max_features=k, pano_height=96, pano_width=768,
                               descriptor_patch=16)
    luts = build_frontend_luts(rig, fe)
    room = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
    pose = make_trajectory(2, radius=0.4)[1]
    img = jax.jit(lambda T: render_frame(rig, T, room))(pose)
    geom = luts.top
    pano = warp = None
    from sosvo.frontend.panorama import warp_panorama
    pano = jax.jit(lambda im: warp_panorama(im, geom))(img)
    smoothed = jax.jit(gaussian_smooth)(pano)
    kps = jax.jit(lambda p: detect(p, fe.max_features,
                                   threshold=fe.detect_threshold * 1e-7,
                                   nms_radius=fe.nms_grid,
                                   border_rows=fe.descriptor_patch // 2 + 2,
                                   detector=fe.detector,
                                   fast_threshold=fe.fast_threshold))(pano)

    t = {}
    t["warp"] = time_amortized(lambda im: warp_panorama(im, geom), img,
                               inner=inner, n=reps)
    t["smooth"] = time_amortized(gaussian_smooth, pano, inner=inner, n=reps)
    t["detect"] = time_amortized(
        lambda p: detect(p, fe.max_features, threshold=fe.detect_threshold * 1e-7,
                         nms_radius=fe.nms_grid,
                         border_rows=fe.descriptor_patch // 2 + 2,
                         detector=fe.detector, fast_threshold=fe.fast_threshold),
        pano, inner=inner, n=reps)
    t["describe_brief"] = time_amortized(
        lambda s: describe(s, kps, smoothed=s), smoothed, inner=inner, n=reps)
    t["describe_sift"] = time_amortized(
        lambda s: describe_sift(s, kps, smoothed=s), smoothed, inner=inner, n=reps)
    t["extract_full_2views"] = time_amortized(
        lambda im: extract_observations(rig, luts, fe, im), img,
        inner=inner, n=reps)
    return {
        "device": str(jax.devices()[0]),
        "image_size": image_size, "k": fe.max_features,
        "pano": [fe.pano_height, fe.pano_width],
        "phases_ms": {n_: round(v * 1e3, 3) for n_, v in t.items()},
        "note": "per-view phase cost except extract_full_2views (both views)",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--images", action="store_true",
                    help="profile the image-mode frontend phases (c2 path)")
    args = ap.parse_args(argv)
    import jax
    from sosvo.utils.runtime import setup_compilation_cache

    setup_compilation_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.images:
        print(json.dumps(image_phase_breakdown(k=args.k), indent=2))
    else:
        print(json.dumps(phase_breakdown(k=args.k), indent=2))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
