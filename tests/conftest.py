"""Test harness configuration.

Runs the whole suite on a virtual 8-device CPU mesh (the standard JAX trick,
SURVEY.md SS4.3) so all sharding/collective code paths execute without real
multi-chip hardware. Must set the env vars BEFORE jax initializes its
backends, hence the top-of-file placement.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# JAX may already have picked its platform from the environment it was started
# with; pin the CPU through jax.config as well, so the suite never opens a GPU.
jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_debug_nans", False)
# Persistent compilation cache: recompiling the suite's jitted functions
# dominates test wall-clock; cache across runs.
from sosvo.utils.runtime import setup_compilation_cache  # noqa: E402

setup_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on the GPU in a child process; skips where "
        "JAX finds none (run on the card: python -m pytest tests/ -m gpu)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def room_seq():
    """Shared rendered room sequence (rig, poses, images) for image-mode tests."""
    import jax.numpy as jnp  # noqa: F401
    from sosvo.sensor.rig import default_rig
    from sosvo.synth.render import RoomScene, render_sequence
    from sosvo.synth.scene import make_trajectory

    rig = default_rig(image_size=768)
    poses = make_trajectory(6, radius=0.4)
    room = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
    imgs = jax.jit(lambda P: render_sequence(rig, P, room))(poses)
    return rig, poses, imgs


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual CPU devices, got {len(devs)}"
    return devs[:8]
