"""Frozen-dataclass config system, JSON-loadable.

JAX-side replacement for the reference's argparse + in-script constants +
pickled model files (SURVEY.md SS5.6). All configs are hashable frozen
dataclasses so they can be passed to jit as static arguments; the five
benchmark presets (BASELINE.json:7-11) ship as JSON files in `configs/`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any


@dataclass(frozen=True)
class FrontendConfig:
    """Feature detection / description / matching knobs (SURVEY.md C6/C7)."""

    max_features: int = 512          # K: fixed feature-slot count per view
    stereo_band_rad: float = 0.06    # +/- azimuth band for stereo matching [P1]
    match_max_distance: float = 80.0  # Hamming acceptance threshold (of 256)
    match_ratio: float = 0.9         # Lowe ratio (best/second-best)
    detect_threshold: float = 4.0    # corner-response acceptance threshold
    nms_grid: int = 3                # local-max suppression radius (pixels)
    pano_height: int = 128           # panorama rows (elevation samples)
    pano_width: int = 1024           # panorama cols (azimuth samples)
    descriptor_patch: int = 24       # BRIEF-style sampling patch size
    detector: str = "harris"         # "harris" | "fast" (FAST-9 + Harris rank, ORB-style)
    fast_threshold: float = 0.04     # FAST segment-test margin (intensity units)
    oriented: bool = False           # steered BRIEF (rBRIEF) via IC_Angle
    n_scales: int = 1                # pyramid levels (factor-2 octaves); K split across levels
    descriptor: str = "brief"        # "brief" (256-bit Hamming) | "sift"
                                     # (128-d float, L2). PERF WARNING: "sift"
                                     # is a PARITY/debug option, not a perf
                                     # path -- its 4x4x8 soft-binned
                                     # histogram is gather-bound, an order of
                                     # magnitude more work than BRIEF.
                                     # ATE on synthetic scenes matches BRIEF.
    match_max_distance_l2: float = 0.7  # L2 acceptance threshold for unit-norm SIFT descriptors


@dataclass(frozen=True)
class RansacConfig:
    """Robust-estimation knobs (SURVEY.md C10)."""

    n_hyps: int = 512                # fixed hypothesis batch per chip [B:5]
    rigid_threshold: float = 0.05    # 3D inlier radius (m), when scoring in 3D
    rigid_angle_threshold: float = 0.02  # bearing inlier threshold (rad)
    essential_threshold: float = 0.01  # angular epipolar threshold (rad)
    min_inliers: int = 10


@dataclass(frozen=True)
class BAConfig:
    """Windowed bundle adjustment knobs (SURVEY.md C13, BASELINE.json:8)."""

    window: int = 5                  # keyframe window size W
    max_landmarks: int = 512         # landmark slots per window
    max_new: int = 96                # max landmark insertions per keyframe
    iters: int = 5                   # LM outer iterations
    huber_delta: float = 0.005       # robust kernel width on bearing residuals
    damping_init: float = 1e-3


@dataclass(frozen=True)
class DistConfig:
    """Mesh / sharding knobs (SURVEY.md SS2.2, BASELINE.json:10-11)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 1           # sequences in parallel (P1-DP)
    model_parallel: int = 1          # landmark shards (P2-TP)
    pgo_shards: int = 1              # > 1: loop-candidate pairs AND pose-graph
                                     # nodes sharded over that many devices for
                                     # the c3 loop-closing stage (P1-DP
                                     # detection + P4-SP time-sharded PGO,
                                     # sosvo/dist/c3_dist.py)


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level VO pipeline configuration -- static under jit."""

    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig()
    ba: BAConfig = BAConfig()
    dist: DistConfig = DistConfig()
    min_triangulation_angle: float = 0.004
    max_range: float = 30.0
    max_ray_gap: float = 0.08
    refine_iters: int = 4            # GN iterations in the bearing refine
                                     # (latency-bound sequential solves).
                                     # The ATE sweep over the noise matrix
                                     # (0..2 px, 0..15% flips) is flat from
                                     # 3 iterations up (<= 0.25% relative
                                     # delta at 4 vs 6 everywhere) -- the
                                     # RANSAC refit init is already inside
                                     # GN's quadratic basin
    use_essential_gate: bool = True
    lazy_essential_gate: bool = True # run the gate only when the rigid
                                     # solve is QUESTIONABLE (inlier fraction
                                     # below lazy_gate_ratio): a lax.cond in
                                     # the scan body skips the whole 2D-2D
                                     # RANSAC on confidently-tracked frames.
                                     # On c1 (0.3 px + 2% desc noise) the
                                     # ATE is IDENTICAL; pose_ok equal to the
                                     # eager gate across the 0..1 px noise /
                                     # 0..45% flip matrix and garbage input
                                     # still fails safely (the failure the
                                     # gate catches drops the inlier
                                     # fraction first, so those frames run
                                     # the full gate -- tests/
                                     # test_pipeline_c1.py::test_lazy_gate_*)
    lazy_gate_ratio: float = 0.9     # rigid inliers / temporal matches below
                                     # which the lazy gate still runs
    keyframe_every: int = 4          # keyframe cadence (frames; stride mode)
    keyframe_mode: str = "stride"    # "stride" | "adaptive" (motion-triggered:
                                     # a frame becomes a keyframe when motion
                                     # since the last keyframe crosses a
                                     # threshold -- dense sampling through
                                     # fast/turning segments, sparse when
                                     # hovering; SURVEY.md C15, COMPAT #11)
    kf_min_gap: int = 1              # frames that must pass before the next kf
    kf_max_gap: int = 12             # force a keyframe after this many frames
    kf_trans_thresh: float = 0.06    # translation since last keyframe (m)
    kf_rot_thresh: float = 0.10      # rotation since last keyframe (rad)
    mode: str = "observations"       # "observations" (c1) or "images" (c2+)
    relocalize: bool = True          # BA mode: on a lost frame (pose_ok
                                     # False), match the frame's stereo
                                     # features against the landmark MAP and
                                     # re-acquire the absolute pose by 3D-3D
                                     # RANSAC -- f2f identity-hold leaves a
                                     # permanent offset once the rig moved
                                     # through a dropout; the map removes it
                                     # (tests/test_reloc.py). lax.cond-gated:
                                     # tracked frames pay nothing.
    reloc_min_inliers: int = 20      # map-match inliers to accept a reloc pose
    pose_graph: bool = False         # run PGO loop closing after replay (c3)
    loop_candidates: int = 0         # loop-detection candidate pairs: 0 = all
                                     # keyframe pairs, M > 0 = top-M by the
                                     # signature prescreen (O(M) detection)
    loop_min_inliers: int = 30       # RANSAC inliers required to accept a loop
                                     # edge. Scale with max_features: weak edges
                                     # are worse than none (measured on c3:
                                     # 30/2048 features made PGO RAISE ATE
                                     # 0.030->0.039; 200 lowered it to 0.025)
    pgo_robust: str = "dcs"          # robust kernel on pose-graph edges:
                                     # "none" | "huber" | "dcs". Second line of
                                     # defense after the inlier gate: bounds the
                                     # damage of a perceptually-aliased (wrong
                                     # but high-inlier) loop edge
    pgo_robust_delta: float = 0.1    # kernel scale on SE(3)-tangent edge
                                     # residual norms (rad/m mixed units)


def _from_dict(cls, d: dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in ("frontend", "ransac", "ba", "dist"):
            sub = {"frontend": FrontendConfig, "ransac": RansacConfig, "ba": BAConfig, "dist": DistConfig}[f.name]
            kwargs[f.name] = _from_dict(sub, v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_pipeline_config(path: str | Path) -> PipelineConfig:
    """Load a PipelineConfig from a JSON preset (configs/c*.json)."""
    with open(path) as f:
        d = json.load(f)
    return _from_dict(PipelineConfig, d.get("pipeline", d))


def dump_pipeline_config(cfg: PipelineConfig) -> dict:
    return dataclasses.asdict(cfg)
