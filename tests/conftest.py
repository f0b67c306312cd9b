"""Test harness config: the JAX CPU backend with 8 virtual devices.

Forced through ``jax.config`` as well as the environment, because jax may
already be imported when this file runs; the update still works as long
as no backend has been initialized.  The 8-device CPU mesh doubles as the
multi-device simulator for the sharding tests.

``JAX_PLATFORMS=cuda`` leaves the platform alone, for running the
``gpu``-marked tests on a card: ``python -m pytest -m gpu tests/``.
"""

import os

if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
