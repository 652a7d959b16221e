"""Test configuration: run the suite on an 8-device virtual CPU mesh.

This is the standard JAX trick for exercising multi-device collectives without
hardware (SURVEY.md §4): ``--xla_force_host_platform_device_count=8`` fakes eight
CPU devices, and sharded sweeps are checked for exact agreement with the
single-device path.  The GPU runs ``chip_smoke.py`` and the tests marked
``chip`` instead.

The platform is flipped *before* the first backend use, which a pytest conftest
import is early enough for, so the suite runs on the CPU even on a GPU host.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
