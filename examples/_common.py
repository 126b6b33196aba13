"""Shared example setup: examples run on JAX's default backend (the GPU
where there is one) and go to the CPU only when asked —
``setup(force_cpu=True)`` or ``MCMC_EXAMPLES_CPU=1`` in the environment.
The CPU backend gets 8 virtual devices, so the multi-device examples run
there too."""

import os
import pathlib
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

from mcmc_tpu.device import enable_compile_cache  # noqa: E402


def setup(force_cpu=False):
    if force_cpu or os.environ.get("MCMC_EXAMPLES_CPU"):
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    return jax
