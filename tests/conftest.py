"""Test configuration.

The suite runs on the CPU by default, with 8 virtual devices so the
sharded paths have a mesh.  Tests that need the GPU carry the `chip`
marker and take the `gpu` fixture, which skips them when JAX finds no
GPU (README "Tests" names the command that runs them on the card).
"""

import os
import random

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scrubbed_cpu_env(n_devices=8):
    """Environment for subprocess tests that need an n-device CPU mesh:
    the repo root on PYTHONPATH, the CPU platform, n virtual devices.
    The repo root is derived from this file (not hardcoded) so the suite
    runs from any checkout location, including CI."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    return env


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX finds none.  Decided
    here, at run time, never while a test module is imported."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return devices[0]


@pytest.fixture
def rng():
    return random.Random(0xC0FFEE)


def rand_sequence(rng, length):
    """Uniform ACTG sequence, mirroring the reference's test generator
    (reference shortseq/tests/util.py:28-40)."""
    return "".join(rng.choice("ACTG") for _ in range(length))
