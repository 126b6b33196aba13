"""Mesh-sharded DE-MCMC sweep.

The reference parallelizes DE with an OpenMP ``parallel for`` over the
population (reference src/de.cpp:161-207); every walker reads the shared
previous-generation matrix. The multi-chip analog (SURVEY.md §7 step 6):
shard the population axis over the mesh, and once per sweep ``all_gather``
the previous generation over the interconnect so each device forms its local walkers'
``X_i + gamma (X_c1 - X_c2) + U[-b,b]`` proposals against the full
population. One collective per generation — cross-chain traffic stays off
the per-walker critical path.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mcmc_tpu.settings import DESettings
from mcmc_tpu.samplers.de import DEState, _distinct_pair_indices, de_cooling_schedule

__all__ = ["build_sharded_de_sweep"]


def build_sharded_de_sweep(box_log_kernel, cfg: DESettings, n_vals: int,
                           mesh: Mesh, axis_name: str = "chains"):
    """Returns ``sweep(keys, state) -> (state, info)`` where ``state.X`` and
    ``state.kernel_vals`` are sharded on the population axis and ``keys`` is
    a per-walker key array sharded the same way."""
    n_pop = cfg.n_pop
    n_dev = mesh.shape[axis_name]
    if n_pop % n_dev != 0:
        raise ValueError(f"n_pop={n_pop} must divide evenly over {n_dev} devices")
    par_gamma = 2.38 / math.sqrt(2.0 * n_vals)
    batched_kernel = jax.vmap(box_log_kernel)

    def local_sweep(keys_l, X_l, kv_l, gen_ind):
        """Runs per device on the local population shard."""
        local_n = X_l.shape[0]
        dev = jax.lax.axis_index(axis_name)
        my_ids = dev * local_n + jnp.arange(local_n)

        X_full = jax.lax.all_gather(X_l, axis_name, tiled=True)   # (n_pop, d)

        use_jump = cfg.jumps & ((gen_ind + 1) % 10 == 0)
        gamma_run = jnp.where(use_jump, cfg.par_gamma_jump, par_gamma).astype(X_l.dtype)

        def per_walker(key, i, x, kv):
            k_idx, k_noise, k_acc = jax.random.split(key, 3)
            c1, c2 = _distinct_pair_indices(k_idx, i, n_pop)
            noise = jax.random.uniform(
                k_noise, (n_vals,), X_l.dtype, minval=-cfg.par_b, maxval=cfg.par_b
            )
            prop = x + gamma_run * (X_full[c1] - X_full[c2]) + noise
            return prop, jax.random.uniform(k_acc, dtype=X_l.dtype)

        props, zs = jax.vmap(per_walker)(keys_l, my_ids, X_l, kv_l)
        prop_vals = batched_kernel(props)
        prop_vals = jnp.where(jnp.isfinite(prop_vals), prop_vals, -jnp.inf)

        temperature = de_cooling_schedule(gen_ind, cfg.n_keep_draws)
        accepted = (prop_vals - kv_l) > temperature * jnp.log(zs)
        X_new = jnp.where(accepted[:, None], props, X_l)
        kv_new = jnp.where(accepted, prop_vals, kv_l)
        return X_new, kv_new, accepted

    sharded = shard_map(
        local_sweep, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P()),
        out_specs=(P(axis_name), P(axis_name), P(axis_name)),
    )

    def sweep(keys, state: DEState):
        X_new, kv_new, accepted = sharded(keys, state.X, state.kernel_vals,
                                          state.gen_ind)
        new_state = DEState(X=X_new, kernel_vals=kv_new,
                            gen_ind=state.gen_ind + 1)
        return new_state, {"accepted": accepted}

    return sweep
