"""Multi-process (multi-host) execution.

The reference is strictly single-process (SURVEY.md §2c: no MPI/NCCL
anywhere); its scale ceiling is one machine's OpenMP threads. Here the
multi-host story is JAX's distributed runtime + GSPMD: every process calls
:func:`init_distributed`, builds the same global :class:`~jax.sharding.Mesh`
over all devices, and runs the same jitted sampler — XLA partitions the
chain axis and inserts collectives over the interconnect (psum for pooled adaptation
statistics, all_gather for DE generations, ppermute for the AEES ladder).

Host-replicated inputs (initial positions, PRNG key batches — every process
computes them identically from the same seed) become global sharded arrays
via :func:`global_chain_array`; each process contributes only its
addressable shards.

Verified in software by ``tests/test_multiprocess.py``: two CPU processes
x 4 virtual devices run chain-sharded HMC end-to-end over an 8-device
global mesh (Gloo collectives across the process boundary — the DCN path's
software stand-in).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from mcmc_tpu.parallel.mesh import CHAIN_AXIS, chain_sharding

__all__ = ["init_distributed", "global_chain_array", "global_mesh"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the JAX distributed runtime. Pass the three arguments
    explicitly (the coordinator as ``host:port``) unless the cluster's
    launcher provides them to JAX. Must run before the first on-device
    computation."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis_name: str = CHAIN_AXIS):
    """1-D mesh over ALL devices of all processes (call after
    :func:`init_distributed`)."""
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis_name,))


def global_chain_array(x, mesh, axis_name: str = CHAIN_AXIS):
    """Turn a host-replicated array (identical on every process) into a
    global jax.Array sharded on the leading chain axis; works for both
    single- and multi-process meshes. Typed PRNG keys are routed through
    ``key_data``/``wrap_key_data``."""
    import jax.numpy as jnp

    is_key = hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jax.dtypes.prng_key)
    if is_key:
        impl = jax.random.key_impl(x)
        raw = np.asarray(jax.random.key_data(x))
        sh = chain_sharding(mesh, raw.ndim, axis_name)
        garr = jax.make_array_from_callback(raw.shape, sh, lambda idx: raw[idx])
        return jax.jit(
            lambda d: jax.random.wrap_key_data(d, impl=impl),
            out_shardings=chain_sharding(mesh, 1, axis_name),
        )(garr)
    x = np.asarray(x)
    sh = chain_sharding(mesh, x.ndim, axis_name)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])
