"""Device-mesh utilities for multi-chip sampling.

The reference's only parallelism is OpenMP threads inside one process
(SURVEY.md §2d). Here the scaling axes are:

- **chains** — embarrassingly data-parallel for RWMH/MALA/HMC/NUTS/RM-HMC;
  sharded over the mesh with ``pjit``-style input shardings, no collectives
  on the hot path;
- **population** — DE's cross-walker difference proposals read the whole
  previous generation, so the sharded sweep all-gathers the population once
  per generation over the interconnect (see ``parallel.de_sharded``);
- **ladder/history** — AEES's cross-temperature reads (gathers over a
  replicated history ring buffer).

On several hosts, call :func:`jax.distributed.initialize` first and pass
the global mesh; one host with several GPUs works out of the box. Every GPU
of a host reaches every other at the same rate, so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "make_grid_mesh", "chain_sharding",
           "shard_chain_axis", "shard_data_axis", "data_parallel_kernel"]

CHAIN_AXIS = "chains"
DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = CHAIN_AXIS) -> Mesh:
    """1-D mesh over (the first ``n_devices``) local/global devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def make_grid_mesh(n_chain_devices: int, n_data_devices: int,
                   axis_names=(CHAIN_AXIS, DATA_AXIS)) -> Mesh:
    """2-D ``(chains, data)`` mesh for tall-data models: the chain batch
    shards over the first axis (as with :func:`make_mesh`) and the
    *dataset* shards over the second (:func:`shard_data_axis`), so a
    single chain's likelihood reduction runs across ``n_data_devices``
    chips with XLA-inserted all-reduces over the interconnect — within-draw
    parallelism the reference's OpenMP-over-chains model has no analog
    for (SURVEY.md §2d "SP/CP... absent"; this is its MCMC counterpart).
    """
    devs = jax.devices()
    need = n_chain_devices * n_data_devices
    if need > len(devs):
        raise ValueError(
            f"mesh {n_chain_devices}x{n_data_devices} needs {need} devices, "
            f"have {len(devs)}")
    grid = np.array(devs[:need]).reshape(n_chain_devices, n_data_devices)
    return Mesh(grid, axis_names)


def chain_sharding(mesh: Mesh, ndim: int, axis_name: str = CHAIN_AXIS) -> NamedSharding:
    """Sharding that splits the leading (chain) axis across the mesh;
    rank-0 leaves (step counters etc.) are replicated."""
    if ndim == 0:
        return NamedSharding(mesh, P())
    return NamedSharding(mesh, P(axis_name, *([None] * (ndim - 1))))


def shard_chain_axis(tree, mesh: Mesh, axis_name: str = CHAIN_AXIS):
    """Place every leaf with its leading axis sharded over the mesh.

    Works for single-process meshes (plain device_put) and multi-process
    global meshes (each process contributes its addressable shards of the
    host-replicated value via ``global_chain_array`` — callers must pass
    identical values on every process, which the fixed-seed PRNG discipline
    guarantees)."""
    multiprocess = any(d.process_index != jax.process_index()
                       for d in mesh.devices.flat)
    if multiprocess:
        from mcmc_tpu.parallel.distributed import global_chain_array
        return jax.tree_util.tree_map(
            lambda x: global_chain_array(x, mesh, axis_name), tree)

    def place(x):
        return jax.device_put(x, chain_sharding(mesh, x.ndim, axis_name))
    return jax.tree_util.tree_map(place, tree)


def shard_data_axis(tree, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Shard every leaf's leading (observation) axis over the mesh's data
    axis — rank-0 leaves replicate. Handles multi-process meshes the same
    way :func:`shard_chain_axis` does (each process contributes its
    addressable shards of the host-replicated value).

    NOTE: arrays a jitted function *closes over* are baked as constants and
    lose this placement (JAX inlines them by value) — sampling with a
    ``log_kernel`` that merely closes over the output of this function runs
    un-partitioned. Use :func:`data_parallel_kernel`, which re-asserts the
    sharding at trace time, for the sampler path; this function is the
    placement primitive for eager work and explicit-argument jits.
    """
    multiprocess = any(d.process_index != jax.process_index()
                       for d in mesh.devices.flat)
    if multiprocess:
        from mcmc_tpu.parallel.distributed import global_chain_array
        return jax.tree_util.tree_map(
            lambda x: global_chain_array(x, mesh, axis_name), tree)

    def place(x):
        x = jnp.asarray(x)
        return jax.device_put(x, chain_sharding(mesh, x.ndim, axis_name))
    return jax.tree_util.tree_map(place, tree)


def data_parallel_kernel(log_kernel_fn, data, mesh: Mesh,
                         axis_name: str = DATA_AXIS):
    """Build a tall-data-parallel ``log_kernel(params)`` from
    ``log_kernel_fn(params, data) -> scalar``.

    ``data`` (any pytree; leading axis = observations) is placed with
    :func:`shard_data_axis` and, crucially, re-annotated with
    ``lax.with_sharding_constraint`` inside the traced function — closures
    alone lose their sharding when jit bakes them into constants — so
    GSPMD partitions the per-observation likelihood terms across the
    mesh's data axis and inserts one all-reduce per log-density/gradient
    evaluation. The scaling-book recipe (annotate shardings, let the
    compiler place collectives): no psum calls in user code, and the same
    kernel composes with chain sharding on a :func:`make_grid_mesh`
    ``(chains, data)`` grid. Leading axes must divide by the data-axis
    size (pad or trim the dataset first).
    """
    data = shard_data_axis(data, mesh, axis_name)

    def wrapped(params):
        d = jax.tree_util.tree_map(
            lambda x: jax.lax.with_sharding_constraint(
                x, chain_sharding(mesh, jnp.ndim(x), axis_name)), data)
        return log_kernel_fn(params, d)

    return wrapped
