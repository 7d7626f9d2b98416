"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set env vars before jax initializes (any jax import in the suite).
"""

import os
import sys

# The suite runs on the CPU; code that needs the GPU is marked `gpu`.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PNGSUITE_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures", "pngsuite"
)
