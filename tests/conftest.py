"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-chip sharding paths
compile and execute without accelerator hardware (SURVEY.md §4); the
platform is set through jax.config (plus XLA_FLAGS before the backend
initializes), so it holds even where JAX_PLATFORMS names another backend.

Tests marked ``gpu`` need the card: they take the ``gpu`` fixture, which
skips them on the CPU. ``python chip_smoke.py`` runs them on the GPU, in its
own process, with ``MCMC_TESTS_ON_GPU=1`` so that the CPU is not forced.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("MCMC_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", "tests must run on cpu"
jax.config.update("jax_threefry_partitionable", True)

# Per-test wall-clock guard: pytest-timeout isn't in this image, so use
# SIGALRM directly. This interrupts Python-level hangs (the common case:
# a scan that never converges, an accidental eager loop); a hang inside a
# single C++ XLA compile won't be interrupted, but --max-worker-restart
# in pyproject addopts recovers from those (and from the known XLA-CPU
# compile-accumulation segfault) at the worker level.
import signal  # noqa: E402

import pytest  # noqa: E402

_TEST_TIMEOUT_S = int(os.environ.get("MCMC_TPU_TEST_TIMEOUT", "900"))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if _TEST_TIMEOUT_S <= 0 or not hasattr(signal, "SIGALRM"):
        yield
        return

    def _on_timeout(signum, frame):
        raise TimeoutError(
            f"test exceeded {_TEST_TIMEOUT_S}s wall-clock "
            "(MCMC_TPU_TEST_TIMEOUT to adjust)"
        )

    prev = signal.signal(signal.SIGALRM, _on_timeout)
    signal.alarm(_TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: `python chip_smoke.py` runs the "
                    "gpu-marked tests on the card")
    return dev
