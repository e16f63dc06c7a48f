"""Profiling helpers (SURVEY.md section 5.1).

`trace()` wraps jax.profiler for Perfetto/XPlane traces; `time_jitted`
benches a compiled callable (compile excluded, median of n);
`time_amortized` times a small function inside one jitted loop.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str = "runs/trace"):
    """Perfetto/XPlane trace of the enclosed block (view with xprof/tensorboard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def time_jitted(fn: Callable, *args, n: int = 10, warmup: int = 1) -> float:
    """Median wall seconds of `fn(*args)` with block_until_ready, post-warmup."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def time_amortized(fn: Callable, x, inner: int = 16, n: int = 5) -> float:
    """Median per-call seconds of `fn(x)`, amortized inside ONE jitted scan.

    For functions of a few to a few hundred microseconds, one dispatch's host
    overhead is of the same order as the work; this runs `inner` dependent
    applications of `fn` inside a single dispatch and divides, so the result
    is the function's own time.
    `x` must be a pytree whose first float leaf exists; a vanishing
    perturbation from each output is folded back into the carry so XLA
    cannot hoist or dead-code the loop body.
    """
    import jax.numpy as jnp

    def fold(c, out):
        leaves = [l for l in jax.tree.leaves(out)
                  if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.floating)]
        eps = sum(jnp.sum(l) for l in leaves) * jnp.float32(1e-38)

        def leaf(a):
            if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
                return a + eps.astype(a.dtype)
            return a
        return jax.tree.map(leaf, c)

    def body(c, _):
        return fold(c, fn(c)), None

    f = jax.jit(lambda x0: jax.lax.scan(body, x0, None, length=inner)[0])
    jax.block_until_ready(f(x))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) / inner
