"""Test configuration: force the CPU backend with a virtual 8-device mesh.

Tests run on the CPU in float64 (correctness oracles at 1e-11), whatever
accelerator the machine has, and validate multi-device sharding on a
virtual 8-device CPU mesh, per the standard JAX practice.  The GPU path
is checked by chip_smoke.py on the card.
"""

import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running oracle (benzene cc-pVDZ SCF etc.)")
