"""Distributed loop detection: candidate pairs sharded over the "data" axis.

Loop-closure detection is embarrassingly parallel over candidate pairs (each
pair runs an independent match + RANSAC + two-frame BA), so the pair batch is
sharded across devices while the keyframe feature tables stay replicated --
P1-DP applied to the c3 long-trajectory path (SURVEY.md section 2.2 / 5.7:
with `dist/pgo_time.py` this makes BOTH halves of loop closing -- producing
edges and solving the graph -- scale with the device count). No collectives
are needed inside: outputs come back sharded and concatenate on the host-side
axis exactly as the single-device `detect_loops`.

The reference has no loop closing at all (frame-to-frame VO [P1]); this
module exists for the north star's multi-host mandate (BASELINE.json:5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sosvo.dist.mesh import DATA_AXIS
from sosvo.sensor.rig import OmnistereoRig
from sosvo.utils.config import PipelineConfig
from sosvo.vo.loop_closure import (
    _kf_features,
    keyframe_signatures,
    loop_edges_for_pairs,
    loop_pairs,
    select_loop_candidates,
)


def detect_loops_sharded(
    mesh: Mesh,
    rig: OmnistereoRig,
    cfg: PipelineConfig,
    obs_kf,
    min_gap: int = 3,
    min_inliers: int = 30,
    key: jax.Array | None = None,
    max_candidates: int | None = None,
):
    """Sharded twin of `sosvo.vo.loop_closure.detect_loops` (same outputs).

    The candidate-pair axis is padded to a multiple of the data-axis size and
    split across devices; each device evaluates its local pairs with the
    shared `loop_edges_for_pairs` worker. Padding slots point at pair (0, 0)
    with weight forced to 0.
    """
    import numpy as np

    n_dev = mesh.shape[DATA_AXIS]
    n_kf = obs_kf.valid_top.shape[0]
    if key is None:
        key = jax.random.PRNGKey(17)

    # ONE jitted program for the whole preamble (keyframe stereo features +
    # signature prescreen): called eagerly, every op is its own dispatch
    # with its own small compile.
    def preamble(o):
        f = _kf_features(rig, cfg, o)
        if max_candidates is None:
            return f, None
        sig = keyframe_signatures(f[1], f[4])
        return f, select_loop_candidates(sig, min_gap, max_candidates)

    feats, selected = jax.jit(preamble)(obs_kf)
    if max_candidates is None:
        pi, pj = loop_pairs(n_kf, min_gap)
        pi, pj = jnp.asarray(pi), jnp.asarray(pj)
        pair_ok = jnp.ones((pi.shape[0],), bool)
    else:
        pi, pj, pair_ok = selected

    m = pi.shape[0]
    m_pad = ((m + n_dev - 1) // n_dev) * n_dev
    if m_pad != m:
        pad = m_pad - m
        pi = jnp.concatenate([pi, jnp.zeros((pad,), pi.dtype)])
        pj = jnp.concatenate([pj, jnp.zeros((pad,), pj.dtype)])
        pair_ok = jnp.concatenate([pair_ok, jnp.zeros((pad,), bool)])
    keys = jax.random.split(key, m_pad)

    worker = functools.partial(loop_edges_for_pairs, rig, cfg,
                               min_inliers=min_inliers)
    fn = shard_map(
        lambda f, a, b, k: worker(f, a, b, k),
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    place = lambda a, s: jax.device_put(a, NamedSharding(mesh, s))
    feats = jax.tree.map(lambda a: place(a, P()), feats)
    T_meas, w = jax.jit(fn)(feats, place(pi, P(DATA_AXIS)),
                            place(pj, P(DATA_AXIS)),
                            place(keys, P(DATA_AXIS)))
    w = w * pair_ok.astype(w.dtype)
    return pj[:m], pi[:m], T_meas[:m], w[:m]
