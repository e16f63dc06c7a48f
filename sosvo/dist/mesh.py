"""Device mesh construction and sharding helpers.

Distributed runtime (SURVEY.md P5-COMM; the reference is a single process
with no parallelism of any kind [K]). Scaling is expressed the idiomatic JAX
way: a named `jax.sharding.Mesh` over the devices, logical axes
  - "data":  independent work items -- sequences in batched replay (P1-DP,
             BASELINE.json:10), RANSAC hypothesis blocks;
  - "model": landmark shards of the BA linear system (P2-TP,
             BASELINE.json:11).
The mesh is built from `jax.devices()` in order and assumes no topology: the
four cards of one host are joined all to all by NVLink, and one process drives
them all. XLA lowers the collectives (`psum`, `all_gather`, `ppermute`) to
NCCL.

Multi-process bootstrap goes through `jax.distributed.initialize()`
(`init_multihost`), after which `jax.devices()` spans every process and the
same mesh code works unchanged.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh over the first data*model visible devices.

    Axis sizes must multiply to the device count used; `data` shards
    independent work, `model` shards the BA landmark axis.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    n = data * model
    if devs.size < n:
        raise ValueError(f"need {n} devices for mesh ({data}x{model}), have {devs.size}")
    return Mesh(devs[:n].reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def model_mesh(model: int | None = None, devices=None) -> Mesh:
    """A 1 x model mesh (pure landmark sharding, config c5)."""
    devs = devices if devices is not None else jax.devices()
    return make_mesh(1, model if model is not None else len(devs), devices=devs)


def data_mesh(data: int | None = None, devices=None) -> Mesh:
    """A data x 1 mesh (pure batched replay, config c4)."""
    devs = devices if devices is not None else jax.devices()
    return make_mesh(data if data is not None else len(devs), 1, devices=devs)


def shard_leading(mesh: Mesh, axis: str, x):
    """Place pytree `x` with its leading dim sharded over `axis`, rest replicated."""
    def put(a):
        spec = P(axis) if getattr(a, "ndim", 0) >= 1 else P()
        return jax.device_put(a, NamedSharding(mesh, spec))
    return jax.tree.map(put, x)


def replicate(mesh: Mesh, x):
    """Fully replicate pytree `x` over the mesh."""
    return jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, P())), x)


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, timeout_s: int = 120) -> None:
    """Multi-host bootstrap: barrier + global device visibility.

    Nothing detects a cluster by itself: pass the coordinator address
    (`localhost:<port>` on one machine), the process count and this
    process's id. Fail-fast on barrier timeout is the failure-detection
    mechanism of SURVEY.md section 5.3.
    """
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(
        initialization_timeout=timeout_s, **kwargs)
