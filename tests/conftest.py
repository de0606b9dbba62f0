"""Test configuration: run JAX on a simulated 8-device CPU mesh so the
distributed (shard_map) paths are exercised without accelerator hardware
(SURVEY.md §4 "Multi-node without a real cluster").

jax.config.update works until the first backend initialization, which is
what pins the CPU backend here. Tests that need the card carry the `gpu`
marker and take the `gpu_device` fixture, which skips them unless JAX's
first device is a GPU; on the machine with the card run them with
`MAXWELL_TEST_GPU=1 python -m pytest tests -m gpu`, which puts the GPU
first.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # read by the CPU PJRT client at creation time — env edit still works here
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update(
    "jax_platforms",
    "cuda,cpu" if os.environ.get("MAXWELL_TEST_GPU") == "1" else "cpu",
)
# double precision available in tests (solver accuracy studies)
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs the GPU: MAXWELL_TEST_GPU=1 python -m pytest -m gpu"
        )
    return dev
