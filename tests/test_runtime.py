"""Process set-up of the entry points: compile-cache placement, and the GPU
requirement of the measurement scripts (`bench.py`, `chip_smoke.py`)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from sosvo.utils import runtime

ROOT = Path(__file__).resolve().parents[1]


def _cpu_env():
    return {**os.environ, "JAX_PLATFORMS": "cpu"}


def test_cache_honours_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.setup_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing in code


def test_cache_defaults_to_fixed_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compilation_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_chip_smoke_refuses_cpu_backend():
    import chip_smoke

    with pytest.raises(runtime.NoGPUError, match="no GPU found"):
        chip_smoke.require_gpu(jax.devices("cpu"))
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu_backend():
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"metric"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Outside a checkout the script fails and prints no verdict."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in _cpu_env().items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def gpu_env():
    """The environment of a process that would use the card, if one exists.

    The suite itself runs on the CPU, so a child process asks JAX."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=300)
    if r.stdout.strip() != "gpu":
        pytest.skip("no GPU here: chip_smoke.py runs only on the card")
    return env


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_env, tmp_path):
    r = subprocess.run([sys.executable, "chip_smoke.py", "--out", str(tmp_path)],
                       cwd=ROOT, env=gpu_env, capture_output=True, text=True,
                       timeout=1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    verdict = json.loads(r.stdout.strip().splitlines()[-1])
    assert verdict["ok"] and verdict["device"]["platform"] == "gpu"
