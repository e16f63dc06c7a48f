"""Distributed windowed BA: landmark blocks sharded over the "model" mesh axis.

Benchmark config c5 (BASELINE.json:11: "landmark blocks sharded across N >= 2
hosts with distributed Schur-complement BA over collectives"). The solver is
the SAME code as single-device BA (`sosvo/backend/ba.py`) run under
`shard_map` with `axis_name="model"`: landmark-indexed state lives sharded,
camera-system reductions psum over the axis (see
`sosvo/backend/schur.py:reduce_camera_system`), and the small reduced solve is
computed replicated on every device. Correctness invariant (tested on the
8-device CPU mesh, SURVEY.md section 4.3): sharded result == single-device
result to f32 reduction tolerance.

XLA lowers the collectives to NCCL across the cards of a host; across
processes the identical code runs after `sosvo.dist.mesh.init_multihost()`.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from sosvo.backend.ba import BAResult, BAWindow, ba_solve
from sosvo.dist.mesh import MODEL_AXIS


def _window_specs() -> BAWindow:
    """PartitionSpecs of a BAWindow under landmark ("model") sharding.

    Poses and viewpoints are replicated; every landmark-indexed leaf is
    sharded on its landmark dimension.
    """
    return BAWindow(
        X=P(),                        # (W, 4, 4) replicated
        landmarks=P(MODEL_AXIS),      # (L, 3) sharded on l
        rays=P(None, MODEL_AXIS),     # (W, L, 2, 3) sharded on l
        weights=P(None, MODEL_AXIS),  # (W, L, 2) sharded on l
        viewpoints=P(),               # (2, 3) replicated
    )


def ba_solve_sharded(mesh: Mesh, win: BAWindow, iters: int = 5,
                     lam0: float = 1e-3) -> BAResult:
    """Solve a BA window with landmarks sharded over `mesh`'s "model" axis.

    The landmark count L must be divisible by the model-axis size. Inputs may
    be host arrays; they are placed according to the window specs.
    """
    specs = _window_specs()
    out_specs = BAResult(X=P(), landmarks=P(MODEL_AXIS), cost=P(), cost0=P(),
                         accepted=P())
    # check_vma=False: the solver's replicated outputs (poses, cost) are
    # produced from psummed quantities, so they are equal on all shards by
    # construction -- but that equality flows through a data-dependent
    # accept/reject scan, which the static varying-manual-axes inference
    # cannot prove. A pcast-based refactor was attempted (r2) and is
    # API-impossible on jax 0.9.0: `jax.lax.pcast` supports only
    # invarying->{varying,reduced} and varying<->unreduced casts -- there is
    # NO varying->invariant direction (the cast the checker would need), so
    # the checker cannot be satisfied without gathering/re-scattering every
    # psummed carry. The replication invariant is instead asserted
    # dynamically: tests/test_ba_dist.py vs the single-device solver, and
    # __graft_entry__.dryrun_multichip in the driver artifact.
    fn = shard_map(
        functools.partial(ba_solve, iters=iters, lam0=lam0, axis_name=MODEL_AXIS),
        mesh=mesh,
        in_specs=(specs,),
        out_specs=out_specs,
        check_vma=False,
    )
    win = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), win, specs
    )
    return jax.jit(fn)(win)
