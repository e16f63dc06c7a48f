"""Time-axis-sharded pose-graph optimization (SURVEY.md P4-SP).

The trajectory/time axis is the framework's "sequence" axis: node states are
SHARDED along time across devices (each device owns a contiguous block of
keyframes), and the two edge classes take different communication paths:

- **Odometry edges** (consecutive keyframes, O(N) of them) stay shard-local
  except at shard boundaries, where the single boundary keyframe is exchanged
  halo-style with `jax.lax.ppermute` over the device ring -- the structural
  analog of ring attention's block exchange. Traffic is O(1) per device per
  matvec, independent of trajectory length.
- **Loop-closure edges** (distant keyframe pairs, few) are handled by an
  `all_gather` of the small per-node vectors plus a global `psum` of their
  contributions.

The solver is damped Gauss-Newton with a matrix-free block-Jacobi PCG inner
solve (the sharded twin of `sosvo.backend.pose_graph._gn_step_cg`): per-node
state and per-edge terms are O(N / n_devices) per device, so pose graphs
scale to arbitrarily long trajectories (SURVEY.md SS5.7 "long context").

The reference has no distributed machinery of any kind [SURVEY.md SS2.2];
this module exists for the north star's multi-host mandate (BASELINE.json:5).
Everything here is meant to run inside `shard_map` over a named mesh axis --
see `pgo_solve_time_sharded` for the entry point that sets that up.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sosvo.backend.pose_graph import (
    GAUGE_PRIOR,
    _edge_jacobians,
    _pcg,
    robust_omega,
    robust_rho,
)
from sosvo.geom.lie import se3_exp


class TimeShardedGraph(NamedTuple):
    """Pose graph laid out for time sharding; leading dims shard over time.

    Global node t lives at shard t // n_loc, local slot t % n_loc. Odometry
    edge slot l on a shard constrains (i = global l+1, j = global l); the very
    last slot of the last shard has no successor node and must carry w = 0.
    Loop edges are replicated (small) and indexed by GLOBAL node ids.
    """

    X: jnp.ndarray           # (N, 4, 4) node poses (shard: leading axis)
    node_valid: jnp.ndarray  # (N,) bool
    T_odo: jnp.ndarray       # (N, 4, 4) odometry measurements X_{t+1} X_t^-1
    w_odo: jnp.ndarray       # (N,) weights; 0 = unused (incl. global last slot)
    loop_i: jnp.ndarray      # (E_loop,) int32 global ids
    loop_j: jnp.ndarray      # (E_loop,) int32 global ids
    T_loop: jnp.ndarray      # (E_loop, 4, 4)
    w_loop: jnp.ndarray      # (E_loop,)


class TimePGOResult(NamedTuple):
    X: jnp.ndarray
    cost: jnp.ndarray
    cost0: jnp.ndarray
    accepted: jnp.ndarray


def _ring_perm(axis_name: str, shift: int):
    """ppermute perm sending shard s's data to shard s - shift (mod D)."""
    D = jax.lax.axis_size(axis_name)
    return [((s + shift) % D, s) for s in range(D)]


def _pull_next_first(x_loc: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Halo pull: every shard receives the FIRST row of the NEXT shard."""
    return jax.lax.ppermute(x_loc[:1], axis_name, _ring_perm(axis_name, 1))[0]


def _push_to_next_first(contrib: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Reverse halo: every shard receives what the PREVIOUS shard computed
    for this shard's first node."""
    D = jax.lax.axis_size(axis_name)
    perm = [((s - 1) % D, s) for s in range(D)]
    return jax.lax.ppermute(contrib[None], axis_name, perm)[0]


def _local_ids(n_loc: int, axis_name: str) -> jnp.ndarray:
    """Global node ids of this shard's slots."""
    d = jax.lax.axis_index(axis_name)
    return d * n_loc + jnp.arange(n_loc, dtype=jnp.int32)


def _shard_terms(g: TimeShardedGraph, axis_name: str):
    """Per-edge residuals/Jacobians for this shard's odometry + handled loop
    edges. Returns odometry terms (aligned with local slots) and loop terms
    (full loop set, masked to this shard's handled subset)."""
    n_loc = g.X.shape[0]
    D = jax.lax.axis_size(axis_name)
    d = jax.lax.axis_index(axis_name)

    # --- odometry: X_i is the next local node, halo for the last slot.
    X_halo = _pull_next_first(g.X, axis_name)                     # (4, 4)
    X_i = jnp.concatenate([g.X[1:], X_halo[None]], axis=0)        # (n_loc,4,4)
    r_o, Ji_o, Jj_o = jax.vmap(_edge_jacobians)(X_i, g.X, g.T_odo, g.w_odo)

    # --- loop edges: each is handled by exactly one shard (round-robin).
    e_loop = g.loop_i.shape[0]
    handled = (jnp.arange(e_loop, dtype=jnp.int32) % D) == d
    w_l = jnp.where(handled, g.w_loop, 0.0)
    X_full = jax.lax.all_gather(g.X, axis_name)                   # (D,n_loc,4,4)
    X_full = X_full.reshape(D * n_loc, 4, 4)
    r_l, Ji_l, Jj_l = jax.vmap(_edge_jacobians)(
        X_full[g.loop_i], X_full[g.loop_j], g.T_loop, w_l)
    return (r_o, Ji_o, Jj_o), (r_l, Ji_l, Jj_l)


def _clamp_loc(g: TimeShardedGraph, axis_name: str) -> jnp.ndarray:
    """(n_loc,) gauge prior: global node 0 anchored + invalid slots clamped."""
    gids = _local_ids(g.X.shape[0], axis_name)
    one_hot = (gids == 0).astype(g.X.dtype)
    return jnp.maximum(one_hot, 1.0 - g.node_valid.astype(g.X.dtype))


def _scatter_odo(Ji_o, Jj_o, t, axis_name: str) -> jnp.ndarray:
    """Route odometry per-edge 6-vectors J^T t back onto local node slots,
    pushing the boundary contribution to the next shard over the ring."""
    u_j = jnp.einsum("erc,er->ec", Jj_o, t)                       # to local l
    u_i = jnp.einsum("erc,er->ec", Ji_o, t)                       # to local l+1
    u = u_j
    u = u.at[1:].add(u_i[:-1])
    u = u.at[0].add(_push_to_next_first(u_i[-1], axis_name))
    return u


def _matvec(g, odo, loop, diag_add, axis_name, v_loc):
    """H @ v with v sharded: halo ppermute for odometry, all_gather+psum for
    loop edges, block-diagonal damping applied locally."""
    r_o, Ji_o, Jj_o = odo
    r_l, Ji_l, Jj_l = loop
    n_loc = v_loc.shape[0]
    D = jax.lax.axis_size(axis_name)
    d = jax.lax.axis_index(axis_name)

    v_halo = _pull_next_first(v_loc, axis_name)
    v_i = jnp.concatenate([v_loc[1:], v_halo[None]], axis=0)
    t_o = jnp.einsum("erc,ec->er", Ji_o, v_i) + jnp.einsum("erc,ec->er", Jj_o, v_loc)
    u = _scatter_odo(Ji_o, Jj_o, t_o, axis_name)

    v_full = jax.lax.all_gather(v_loc, axis_name).reshape(D * n_loc, 6)
    t_l = (jnp.einsum("erc,ec->er", Ji_l, v_full[g.loop_i])
           + jnp.einsum("erc,ec->er", Jj_l, v_full[g.loop_j]))
    u_full = jnp.zeros_like(v_full)
    u_full = u_full.at[g.loop_i].add(jnp.einsum("erc,er->ec", Ji_l, t_l))
    u_full = u_full.at[g.loop_j].add(jnp.einsum("erc,er->ec", Jj_l, t_l))
    u_full = jax.lax.psum(u_full, axis_name)
    u = u + jax.lax.dynamic_slice_in_dim(u_full, d * n_loc, n_loc, axis=0)
    return u + diag_add[:, None] * v_loc


def _reweight(terms, robust: str, delta: float):
    """IRLS: scale (r, J_i, J_j) by sqrt(omega(||r||^2)) per edge.

    Same kernel semantics as `sosvo.backend.pose_graph` (robust_omega); the
    per-edge weights are shard-local functions of shard-local residuals, so no
    extra communication is introduced."""
    r, J_i, J_j = terms
    if robust == "none":
        return terms
    sw = jnp.sqrt(robust_omega(jnp.sum(r * r, axis=-1), robust, delta))
    return r * sw[:, None], J_i * sw[:, None, None], J_j * sw[:, None, None]


def _gn_step(g: TimeShardedGraph, lam, axis_name: str, cg_iters: int,
             robust: str = "none", robust_delta: float = 0.1):
    n_loc = g.X.shape[0]
    D = jax.lax.axis_size(axis_name)
    d = jax.lax.axis_index(axis_name)
    odo, loop = _shard_terms(g, axis_name)
    odo = _reweight(odo, robust, robust_delta)
    loop = _reweight(loop, robust, robust_delta)
    r_o, Ji_o, Jj_o = odo
    r_l, Ji_l, Jj_l = loop

    # Gradient b and block-Jacobi diagonal D_blk, same routing as the matvec.
    b = _scatter_odo(Ji_o, Jj_o, r_o, axis_name)
    b_full = jnp.zeros((D * n_loc, 6), g.X.dtype)
    b_full = b_full.at[g.loop_i].add(jnp.einsum("erc,er->ec", Ji_l, r_l))
    b_full = b_full.at[g.loop_j].add(jnp.einsum("erc,er->ec", Jj_l, r_l))
    b_full = jax.lax.psum(b_full, axis_name)
    b = b + jax.lax.dynamic_slice_in_dim(b_full, d * n_loc, n_loc, axis=0)

    D_blk = jnp.einsum("eri,erj->eij", Jj_o, Jj_o)
    Dii = jnp.einsum("eri,erj->eij", Ji_o, Ji_o)
    D_blk = D_blk.at[1:].add(Dii[:-1])
    D_blk = D_blk.at[0].add(_push_to_next_first(Dii[-1], axis_name))
    D_full = jnp.zeros((D * n_loc, 6, 6), g.X.dtype)
    D_full = D_full.at[g.loop_i].add(jnp.einsum("eri,erj->eij", Ji_l, Ji_l))
    D_full = D_full.at[g.loop_j].add(jnp.einsum("eri,erj->eij", Jj_l, Jj_l))
    D_full = jax.lax.psum(D_full, axis_name)
    D_blk = D_blk + jax.lax.dynamic_slice_in_dim(D_full, d * n_loc, n_loc, axis=0)

    diag_add = lam + GAUGE_PRIOR * _clamp_loc(g, axis_name)       # (n_loc,)
    D_blk = D_blk + diag_add[:, None, None] * jnp.eye(6, dtype=g.X.dtype)

    # Invert the block-diagonal ONCE (closed-form unrolled-Cholesky SPD
    # inverse, sosvo/backend/schur.py) instead of a batched LU solve inside
    # every PCG iteration: the (n_loc, 6, 6) jnp.linalg.solve lowers to
    # XLA's blocked-loop kernel inside every iteration.
    from sosvo.backend.schur import inv6x6_spd

    D_inv = inv6x6_spd(D_blk)

    def precond(v):
        return jnp.einsum("nij,nj->ni", D_inv, v)

    def psum_dot(a, c):
        return jax.lax.psum(jnp.sum(a * c), axis_name)

    delta = _pcg(functools.partial(_matvec, g, odo, loop, diag_add, axis_name),
                 precond, -b, cg_iters, dot=psum_dot)
    delta = delta * (1.0 - _clamp_loc(g, axis_name))[:, None]
    return g._replace(X=jnp.einsum("nij,njk->nik", se3_exp(delta), g.X))


def _cost(g: TimeShardedGraph, axis_name: str,
          robust: str = "none", robust_delta: float = 0.1) -> jnp.ndarray:
    """Robustified total cost (rho-cost, the accept/reject metric). Each loop
    edge is weighted on exactly one shard (w=0 elsewhere, rho(0)=0), so the
    psum counts it once."""
    odo, loop = _shard_terms(g, axis_name)
    c = 0.5 * (
        jnp.sum(robust_rho(jnp.sum(odo[0] ** 2, axis=-1), robust, robust_delta))
        + jnp.sum(robust_rho(jnp.sum(loop[0] ** 2, axis=-1), robust, robust_delta)))
    return jax.lax.psum(c, axis_name)


def _solve_local(g: TimeShardedGraph, iters: int, lam0: float, cg_iters: int,
                 axis_name: str, robust: str = "none",
                 robust_delta: float = 0.1) -> TimePGOResult:
    # NOTE: runs under check_vma=False (see pgo_solve_time_sharded) -- the
    # replicated cost/accept values are equal on all shards by construction
    # (they come out of psums), which the static checker cannot prove through
    # the accept/reject scan.
    cost0 = _cost(g, axis_name, robust, robust_delta)
    lam = jnp.asarray(lam0, g.X.dtype)

    def body(carry, _):
        gg, lam, cost = carry
        cand = _gn_step(gg, lam, axis_name, cg_iters, robust, robust_delta)
        cand_cost = _cost(cand, axis_name, robust, robust_delta)
        accept = cand_cost < cost
        g_next = jax.tree.map(lambda a, b: jnp.where(accept, a, b), cand, gg)
        lam_next = jnp.clip(jnp.where(accept, lam / 3.0, lam * 9.0), 1e-9, 1e4)
        return (g_next, lam_next, jnp.where(accept, cand_cost, cost)), accept

    (g_fin, _, cost_fin), accepted = jax.lax.scan(
        body, (g, lam, cost0), None, length=iters)
    return TimePGOResult(X=g_fin.X, cost=cost_fin, cost0=cost0, accepted=accepted)


def pgo_solve_time_sharded(
    mesh: Mesh,
    axis_name: str,
    g: TimeShardedGraph,
    iters: int = 10,
    lam0: float = 1e-4,
    cg_iters: int = 32,
    robust: str = "none",
    robust_delta: float = 0.1,
) -> TimePGOResult:
    """Solve a pose graph with node states sharded along time over `axis_name`.

    N (= g.X.shape[0]) must divide by the axis size. Returns the result with
    X sharded the same way; cost scalars replicated. `robust`/`robust_delta`
    mirror `sosvo.backend.pose_graph.pgo_solve` (huber/dcs IRLS on edges).
    """
    n_axis = mesh.shape[axis_name]
    if g.X.shape[0] % n_axis != 0:
        raise ValueError(f"N={g.X.shape[0]} not divisible by axis size {n_axis}")
    fn = _jitted_solver(mesh, axis_name, iters, lam0, cg_iters, robust,
                        robust_delta)
    return fn(g)


@functools.lru_cache(maxsize=32)
def _jitted_solver(mesh, axis_name, iters, lam0, cg_iters, robust,
                   robust_delta):
    """One jitted shard_map program per (mesh, solver-config) key.

    Building the shard_map + jit closure INSIDE the solve meant every call
    retraced and re-lowered the whole program, while the solve itself
    executes in milliseconds. Mesh and the config scalars are hashable, so
    an lru_cache turns repeat solves into plain jit-cache hits.
    """
    time_spec = TimeShardedGraph(
        X=P(axis_name), node_valid=P(axis_name),
        T_odo=P(axis_name), w_odo=P(axis_name),
        loop_i=P(), loop_j=P(), T_loop=P(), w_loop=P(),
    )
    fn = shard_map(
        functools.partial(_solve_local, iters=iters, lam0=lam0,
                          cg_iters=cg_iters, axis_name=axis_name,
                          robust=robust, robust_delta=robust_delta),
        mesh=mesh,
        in_specs=(time_spec,),
        out_specs=TimePGOResult(X=P(axis_name), cost=P(), cost0=P(), accepted=P()),
        check_vma=False,
    )
    return jax.jit(fn)
