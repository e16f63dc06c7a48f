"""Schur reduction of BA's landmark blocks (`sosvo/backend/schur.py`) against
a float64 reference, under landmark sharding, and with empty landmark slots."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sosvo.backend.ba import build_blocks
from sosvo.backend.schur import inv3x3, reduce_camera_system
from sosvo.backend.schur_reference import (SCHUR_RTOL_B, SCHUR_RTOL_S,
                                           ba_window, schur_rel_errors)

LAM = 1e-3


def _damped_blocks(win):
    H_cc, H_cl, H_ll, b_c, b_l, _ = build_blocks(win)
    return H_cc + LAM * jnp.eye(6), H_cl, H_ll + LAM * jnp.eye(3), b_c, b_l


def _reduce(H_cc, H_cl, H_ll, b_c, b_l, axis_name=None):
    return reduce_camera_system(H_cc, H_cl, inv3x3(H_ll), b_c, b_l, axis_name)


@pytest.mark.parametrize("W,L", [(5, 512), (8, 1024)])
def test_reduce_camera_system_matches_float64(W, L):
    es, eb = schur_rel_errors(W, L, seed=W)
    assert es < SCHUR_RTOL_S and eb < SCHUR_RTOL_B, (es, eb)


def test_reduce_camera_system_sharded_equals_single(devices8):
    """Per-shard partials psummed over the "model" axis == one device."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from sosvo.dist.mesh import MODEL_AXIS, model_mesh

    blocks = _damped_blocks(ba_window(5, 512, seed=3))
    S_1, b_1 = jax.jit(_reduce)(*blocks)
    fn = shard_map(
        functools.partial(_reduce, axis_name=MODEL_AXIS),
        mesh=model_mesh(8, devices=devices8),
        in_specs=(P(), P(None, MODEL_AXIS), P(MODEL_AXIS), P(), P(MODEL_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    S_8, b_8 = jax.jit(fn)(*blocks)
    scale = float(jnp.max(jnp.abs(S_1)))
    assert float(jnp.max(jnp.abs(S_8 - S_1))) / scale < 1e-6
    assert float(jnp.max(jnp.abs(b_8 - b_1))) / float(jnp.max(jnp.abs(b_1))) < 1e-6


def test_zero_weight_landmark_slots_leave_reduction_unchanged():
    """Empty map slots (weight 0, the keyframe map's padding) add nothing."""
    win = ba_window(5, 256, seed=4)
    S_ref, b_ref = jax.jit(_reduce)(*_damped_blocks(win))
    pad = 64
    padded = win._replace(
        landmarks=jnp.concatenate([win.landmarks, jnp.zeros((pad, 3))]),
        rays=jnp.concatenate([win.rays, jnp.zeros((5, pad, 2, 3))], axis=1),
        weights=jnp.concatenate([win.weights, jnp.zeros((5, pad, 2))], axis=1))
    S, b_red = jax.jit(_reduce)(*_damped_blocks(padded))
    np.testing.assert_allclose(np.asarray(S), np.asarray(S_ref), rtol=0,
                               atol=1e-6 * float(jnp.max(jnp.abs(S_ref))))
    np.testing.assert_allclose(np.asarray(b_red), np.asarray(b_ref), rtol=0,
                               atol=1e-6 * float(jnp.max(jnp.abs(b_ref))))
