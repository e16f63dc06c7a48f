#!/usr/bin/env python
"""Worker for the 2-process multi-host BA test (SURVEY.md P5-COMM).

Each process calls the REAL multi-host bootstrap
(`sosvo.dist.mesh.init_multihost` -> `jax.distributed.initialize`), after
which `jax.devices()` spans both processes and the landmark-sharded Schur BA
(`sosvo.dist.ba_dist.ba_solve_sharded`) runs over a GLOBAL "model" mesh --
its psums cross the process boundary (Gloo on CPU; NCCL across GPUs, same
code). Process 0 also solves single-device and asserts parity.

Usage: multihost_worker.py <process_id> <num_processes> <port>
Env:   XLA_FLAGS=--xla_force_host_platform_device_count=N  (local devices)
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_platforms", "cpu")

from sosvo.utils.runtime import setup_compilation_cache  # noqa: E402

setup_compilation_cache()


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from sosvo.dist.mesh import init_multihost

    init_multihost(coordinator=f"localhost:{port}", num_processes=nproc,
                   process_id=pid, timeout_s=60)

    import jax.numpy as jnp

    from sosvo.backend.ba import BAWindow, ba_solve
    from sosvo.dist.ba_dist import ba_solve_sharded
    from sosvo.dist.mesh import model_mesh
    from sosvo.geom.lie import mat_inv, se3_exp, transform_points
    from sosvo.sensor.model import viewpoint
    from sosvo.sensor.rig import default_rig
    from sosvo.synth.scene import make_scene

    n_global = jax.device_count()
    mesh = model_mesh(n_global)

    # Deterministic noisy window, identical on both processes (same seeds).
    W, L = 4, 64 * n_global
    rig = default_rig()
    scene = make_scene(jax.random.PRNGKey(0), n_frames=W, n_landmarks=L)
    lms = scene.landmarks[:L]
    X = jax.vmap(mat_inv)(scene.poses[:W])
    vps = jnp.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    p_rig = jax.vmap(lambda Xw: transform_points(Xw, lms))(X)
    d = p_rig[:, :, None, :] - vps[None, None]
    rays = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    rays = rays + 2e-3 * jax.random.normal(jax.random.PRNGKey(1), rays.shape)
    rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
    X0 = jnp.einsum("wij,wjk->wik",
                    se3_exp(0.01 * jax.random.normal(jax.random.PRNGKey(2),
                                                     (W, 6))), X)
    lms0 = lms + 0.01 * jax.random.normal(jax.random.PRNGKey(3), lms.shape)
    win = BAWindow(X=X0, landmarks=lms0, rays=rays,
                   weights=jnp.ones((W, L, 2), jnp.float32), viewpoints=vps)

    res = ba_solve_sharded(mesh, win, iters=3)
    X_sharded = jax.device_get(res.X)          # replicated output
    cost, cost0 = float(res.cost), float(res.cost0)

    out = {"pid": pid, "local_devices": jax.local_device_count(),
           "global_devices": n_global, "cost0": cost0, "cost": cost}
    if pid == 0:
        ref = ba_solve(win, iters=3)
        x_diff = float(jnp.max(jnp.abs(X_sharded - ref.X)))
        c_diff = abs(cost - float(ref.cost))
        assert cost0 > 1e-6, "degenerate window"
        assert cost < cost0, "BA did not reduce cost"
        assert x_diff < 1e-4, f"multihost sharded BA diverges: {x_diff}"
        assert c_diff < 1e-6 + 1e-3 * cost0, f"cost mismatch: {c_diff}"
        out.update({"x_diff_vs_single": x_diff, "parity": "OK"})

    # --- P4-SP across processes: time-sharded PGO, ring-ppermute halos ---
    # Node states shard along time over the GLOBAL mesh, so the odometry
    # halo exchange and the loop-edge all_gather+psum cross the process
    # boundary too.
    from jax.sharding import Mesh, PartitionSpec as P
    import numpy as np

    from sosvo.backend.pose_graph import PoseGraph, pgo_solve
    from sosvo.dist.pgo_time import TimeShardedGraph, pgo_solve_time_sharded

    n_nodes, e_loop = 4 * n_global, 6
    ang = jnp.linspace(0.0, 2 * jnp.pi, n_nodes, endpoint=False)
    tang = jnp.stack([0 * ang, 0 * ang, ang, jnp.cos(ang), jnp.sin(ang),
                      0.1 * jnp.sin(2 * ang)], -1).astype(jnp.float32)
    X_gt = jax.vmap(se3_exp)(tang)
    pert = 0.03 * jax.random.normal(jax.random.PRNGKey(5), (n_nodes, 6),
                                    dtype=jnp.float32).at[0].set(0.0)
    Xn = jnp.einsum("nij,njk->nik", jax.vmap(se3_exp)(pert), X_gt)
    T_next = jnp.concatenate([X_gt[1:], X_gt[:1]])
    T_odo = jnp.einsum("nij,njk->nik", T_next, jax.vmap(mat_inv)(X_gt))
    w_odo = jnp.ones(n_nodes, jnp.float32).at[n_nodes - 1].set(0.0)
    li = jnp.arange(n_nodes // 2, n_nodes // 2 + e_loop, dtype=jnp.int32)
    lj = jnp.arange(0, e_loop, dtype=jnp.int32)
    T_loop = jnp.einsum("nij,njk->nik", X_gt[li], jax.vmap(mat_inv)(X_gt[lj]))
    g = TimeShardedGraph(X=Xn, node_valid=jnp.ones(n_nodes, bool),
                         T_odo=T_odo, w_odo=w_odo, loop_i=li, loop_j=lj,
                         T_loop=T_loop, w_loop=jnp.ones(e_loop, jnp.float32))
    tmesh = Mesh(np.asarray(jax.devices()), ("time",))
    res_t = pgo_solve_time_sharded(tmesh, "time", g, iters=6, cg_iters=60)
    pgo_cost = float(res_t.cost)
    out["pgo_cost"] = pgo_cost
    if pid == 0:
        g_flat = PoseGraph(
            X=Xn, node_valid=jnp.ones(n_nodes, bool),
            ei=jnp.concatenate([jnp.arange(1, n_nodes, dtype=jnp.int32), li]),
            ej=jnp.concatenate([jnp.arange(0, n_nodes - 1, dtype=jnp.int32), lj]),
            T_meas=jnp.concatenate([T_odo[:n_nodes - 1], T_loop]),
            w=jnp.ones(n_nodes - 1 + e_loop, jnp.float32))
        dense = pgo_solve(g_flat, iters=6)
        # res_t.X is sharded over processes; compare the replicated COST and
        # the locally-addressable node shard.
        local_ids = [int(s.index[0].start or 0)
                     for s in res_t.X.addressable_shards]
        x_err = 0.0
        for s in res_t.X.addressable_shards:
            lo = s.index[0].start or 0
            hi = s.index[0].stop or n_nodes
            x_err = max(x_err, float(jnp.max(jnp.abs(
                s.data - jax.device_get(dense.X[lo:hi])))))
        assert float(res_t.cost) < 0.1 * float(res_t.cost0)
        assert x_err < 3e-3, f"time-sharded PGO diverges cross-process: {x_err}"
        out.update({"pgo_x_diff_local_shards": x_err, "pgo_parity": "OK",
                    "pgo_local_node_blocks": local_ids})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
