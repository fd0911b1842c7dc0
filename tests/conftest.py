"""Test harness: run JAX on a simulated 8-device CPU mesh.

Must set the env before the first ``import jax`` anywhere in the test
process (SURVEY.md section 4: multi-device tests via
``xla_force_host_platform_device_count``).
"""

import os

# Hard-set: unit tests always run on the simulated CPU mesh, even on a host
# with a GPU (chip_smoke.py and the `gpu`-marked test own the card). An
# installed accelerator plugin may override the env var, so force the
# config knob too (must happen before first backend use).
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
