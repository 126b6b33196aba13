"""Mesh-sharded stretch-move (Goodman & Weare) ensemble sweep.

The walker axis is sharded over the mesh; each half-update all-gathers the
complementary half once over the interconnect so every device forms its local walkers'
stretch proposals ``X_j + z (X_i - X_j)`` against the *full* complementary
half — partner choice must be uniform over all of it, not the local shard,
for the move's stationarity argument to hold.  Two collectives per sweep
(one per half-update), off the per-walker critical path, mirroring the
sharded DE design (``parallel/de_sharded.py``).

The sweep consumes ONE key per generation (the unsharded convention in
``samplers/stretch.py``); per-device streams are derived by folding in the
device's axis index, so results are deterministic for a fixed key and mesh
size.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mcmc_tpu.settings import StretchSettings
from mcmc_tpu.samplers.stretch import StretchState

__all__ = ["build_sharded_stretch_sweep"]


def build_sharded_stretch_sweep(box_log_kernel, cfg: StretchSettings,
                                n_vals: int, mesh: Mesh,
                                axis_name: str = "chains"):
    """Returns ``sweep(key, state) -> (state, info)`` where ``state.X`` /
    ``state.kernel_vals`` are sharded on the walker axis.  Walker layout:
    rows ``[0, h)`` are half A and ``[h, n_walkers)`` half B, as in the
    unsharded sweep; each device therefore holds a contiguous slice of one
    or both halves, and the half split is done on the *global* row index."""
    n_w = int(cfg.n_walkers)
    h = n_w // 2
    n_dev = mesh.shape[axis_name]
    if n_w % (2 * n_dev) != 0:
        raise ValueError(
            f"n_walkers={n_w} must divide evenly into two halves over "
            f"{n_dev} devices (need n_walkers % {2 * n_dev} == 0)")
    batched_kernel = jax.vmap(box_log_kernel)
    par_a = cfg.par_a

    def local_sweep(key, X_l, kv_l):
        local_n = X_l.shape[0]
        dtype = X_l.dtype
        dev = jax.lax.axis_index(axis_name)
        my_rows = dev * local_n + jnp.arange(local_n)
        key = jax.random.fold_in(key, dev)

        def half_update(key, X_l, kv_l, active_is_a):
            # mask of local rows belonging to the active half
            in_active = (my_rows < h) == active_is_a
            # gather the full complementary half: all devices exchange their
            # local rows; rows outside the complement are masked out of the
            # partner draw by indexing only the complement's global range
            X_full = jax.lax.all_gather(X_l, axis_name, tiled=True)  # (n_w, d)
            comp_start = jnp.where(active_is_a, h, 0)

            k_j, k_z, k_u = jax.random.split(key, 3)
            j = jax.random.randint(k_j, (local_n,), 0, h) + comp_start
            partner = X_full[j]

            u = jax.random.uniform(k_z, (local_n,), dtype)
            a = jnp.asarray(par_a, dtype)
            z = ((a - 1.0) * u + 1.0) ** 2 / a

            prop = partner + z[:, None] * (X_l - partner)
            prop_vals = batched_kernel(prop)
            prop_vals = jnp.where(jnp.isfinite(prop_vals), prop_vals,
                                  -jnp.inf)

            log_acc = (n_vals - 1) * jnp.log(z) + prop_vals - kv_l
            accepted = in_active & (
                jnp.log(jax.random.uniform(k_u, (local_n,), dtype))
                < jnp.minimum(0.0, log_acc))

            X_new = jnp.where(accepted[:, None], prop, X_l)
            kv_new = jnp.where(accepted, prop_vals, kv_l)
            return X_new, kv_new, accepted

        k0, k1 = jax.random.split(key)
        X_l, kv_l, acc_a = half_update(k0, X_l, kv_l, True)
        X_l, kv_l, acc_b = half_update(k1, X_l, kv_l, False)
        return X_l, kv_l, acc_a | acc_b

    sharded = shard_map(
        local_sweep, mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P(axis_name)),
    )

    def sweep(key, state: StretchState):
        X_new, kv_new, accepted = sharded(key, state.X, state.kernel_vals)
        return StretchState(X=X_new, kernel_vals=kv_new), \
            {"accepted": accepted}

    return sweep
