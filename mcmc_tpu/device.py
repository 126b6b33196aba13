"""The accelerator check and the compile cache, shared by the entry scripts
(``chip_smoke.py``, ``bench.py``, ``benchmarks/*.py``, the examples).

A measurement that lands on the wrong device measures the wrong thing, so
the scripts ask :func:`require_accelerator` for the device and stop when it
is absent — they never fall back to the CPU unless told to.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["AcceleratorMissing", "require_accelerator", "enable_compile_cache",
           "CACHE_DIR"]

# fixed, in-checkout default: the cache key includes the path, so a
# directory that moves between runs never hits
CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


class AcceleratorMissing(RuntimeError):
    """JAX found no device of the expected platform."""


def require_accelerator(platform: str = "gpu") -> jax.Device:
    """Return JAX's first device, or raise :class:`AcceleratorMissing` when
    its platform is not ``platform`` (``"gpu"`` for the card; ``"cpu"`` only
    for an explicit CPU rehearsal)."""
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:  # a requested backend failed to initialise
        raise AcceleratorMissing(
            f"no {platform} device: JAX could not start a backend ({e})") from e
    if dev.platform != platform:
        raise AcceleratorMissing(
            f"no {platform} device: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); run on a machine with an NVIDIA GPU")
    return dev


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set; otherwise the cache is the fixed ``.jax_cache``
    at the root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
