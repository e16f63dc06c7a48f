"""Process set-up shared by the entry points: compile cache and device checks.

The persistent compilation cache lives where `JAX_COMPILATION_CACHE_DIR`
says (JAX reads that variable itself), and otherwise at one fixed directory
inside the checkout. The path is part of what JAX's cache can find again,
so it carries no temporary name, process id or time.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def setup_compilation_cache() -> str:
    """Place JAX's persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


class NoGPUError(RuntimeError):
    """Raised by measurement paths that found no GPU (they never fall back)."""


def require_gpu(devices) -> None:
    """Refuse to measure on anything but a GPU."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise NoGPUError(f"no GPU found: JAX's default backend is {platform!r}")


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s card name and power limit, read without touching JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return r.stdout.strip() or f"nvidia-smi failed: {r.stderr.strip()}"
