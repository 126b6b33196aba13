"""Mesh-sharded parallel tempering: one ladder rung per device, swaps over the interconnect.

The library sampler (:mod:`mcmc_tpu.samplers.pt`) runs the whole ladder as a
``(K, d)`` batch on each device. This variant shards the ladder itself —
rung ``k`` lives on mesh device ``k`` — for problems where a single replica's
inner move saturates a chip (large ``d``, expensive kernels):

- inner tempered moves are device-local;
- a swap round is two neighbor ``ppermute``s (state + kernel value up and
  down the ladder) plus a **symmetric decision**: both ends of an active
  pair derive the same uniform from a shared key folded with
  ``(draw_ind, pair_index)``, compute the same Metropolis ratio from the
  exchanged kernel values, and therefore agree on the swap without any
  extra communication — the whole exchange is one (d + 1)-float neighbor
  transfer each way per round, riding the interconnect.

The ladder is fixed here (run the library sampler with ``adapt_temps=True``
first and pass the adapted ladder as ``temper_vec``). Swap/accept semantics
match :func:`mcmc_tpu.pt` exactly; only the RNG stream layout differs
(per-device streams + the shared swap stream), so agreement with the library
sampler is distributional, not bitwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import PTSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers.pt import make_ladder, make_inner_move
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["pt_sharded"]


def pt_sharded(initial_vals, log_kernel, settings=None, *, mesh: Mesh,
               key=None, dtype=None, axis_name: str = "chains") -> SamplerResult:
    """Run PT with the temperature ladder sharded over ``mesh`` (one rung per
    device; requires ladder size == mesh size). Returns the cold chain's kept
    draws like :func:`mcmc_tpu.pt` (single-ladder, so the chain axis is
    squeezed)."""
    algo, s = resolve_settings(settings, "pt_settings", PTSettings)
    key = resolve_key(key, algo)
    if s.adapt_temps:
        raise ValueError("pt_sharded runs a fixed ladder; adapt with "
                         "mcmc_tpu.pt first and pass the result as temper_vec")

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype)
    dim, dt, box = prob.n_vals, prob.dtype, prob.box_log_kernel

    temps = make_ladder(s, dt)
    K = int(temps.shape[0])
    n_dev = mesh.shape[axis_name]
    if K != n_dev:
        raise ValueError(f"ladder size {K} must equal mesh size {n_dev}")
    betas = 1.0 / temps
    # the single shared replica-move implementation (samplers/pt.py)
    inner_move = make_inner_move(box, s, dim, dt)
    swap_every = max(int(s.swap_every), 1)

    first = prob.first_draw[0]
    kv_init = box(first)
    kv_init = jnp.where(jnp.isfinite(kv_init), kv_init, -jnp.inf)
    n_total = s.n_burnin_draws + s.n_keep_draws
    perm_up = [(i, i + 1) for i in range(K - 1)]     # k receives from k-1
    perm_down = [(i + 1, i) for i in range(K - 1)]   # k receives from k+1

    def ladder_run(dev_key):
        k = lax.axis_index(axis_name)
        my_beta = betas[k]
        my_temp = temps[k]

        def body(carry, draw_ind):
            key_, x, kv = carry
            key_, k_move = jax.random.split(key_)
            x, kv, acc = inner_move(k_move, x, kv, my_beta, my_temp)

            # neighbor exchange: my (x, kv) one rung up and one rung down
            above_x = lax.ppermute(x, axis_name, perm_up)     # from k-1
            above_kv = lax.ppermute(kv, axis_name, perm_up)
            below_x = lax.ppermute(x, axis_name, perm_down)   # from k+1
            below_kv = lax.ppermute(kv, axis_name, perm_down)

            swap_round = draw_ind // swap_every
            do_round = (draw_ind % swap_every) == (swap_every - 1)
            parity = swap_round % 2
            is_left = ((k % 2) == parity) & (k + 1 <= K - 1)
            is_right = ((k % 2) != parity) & (k >= 1)
            pair_start = jnp.where(is_left, k, k - 1)
            active = do_round & (is_left | is_right)

            # symmetric decision: both ends fold the SAME (draw, pair) into
            # the shared base key, so the uniform — and the verdict — agree
            shared = jax.random.fold_in(
                jax.random.fold_in(swap_key, draw_ind), pair_start)
            u = jax.random.uniform(shared, dtype=dt)

            kv_left = jnp.where(is_left, kv, above_kv)
            kv_right = jnp.where(is_left, below_kv, kv)
            beta_left = betas[pair_start]
            beta_right = betas[jnp.minimum(pair_start + 1, K - 1)]
            log_alpha = (beta_left - beta_right) * (kv_right - kv_left)
            acc_swap = active & (jnp.log(u) < jnp.minimum(0.0, log_alpha))

            partner_x = jnp.where(is_left, below_x, above_x)
            partner_kv = jnp.where(is_left, below_kv, above_kv)
            x = jnp.where(acc_swap, partner_x, x)
            kv = jnp.where(acc_swap, partner_kv, kv)

            return (key_, x, kv), (x, acc, acc_swap.astype(dt),
                                   active.astype(dt))

        carry0 = (dev_key[0],
                  lax.pcast(first, axis_name, to='varying'),
                  lax.pcast(kv_init, axis_name, to='varying'))
        _, (xs, accs, sw_acc, sw_att) = lax.scan(
            body, carry0, jnp.arange(n_total))
        keep = slice(s.n_burnin_draws, None)
        return (xs[None, keep], accs[None, keep],
                sw_acc[None, keep], sw_att[None, keep])

    key, swap_key = jax.random.split(key)
    dev_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(K))
    # place the per-rung keys as a mesh-sharded (global) array: on a
    # multi-process mesh shard_map inputs must be global jax.Arrays (every
    # process computes the identical host value and contributes its
    # addressable shards); on a single process this is a plain device_put
    from mcmc_tpu.parallel.mesh import shard_chain_axis
    dev_keys = shard_chain_axis(dev_keys, mesh, axis_name)
    sharded = shard_map(
        ladder_run, mesh=mesh,
        in_specs=(P(axis_name),),
        out_specs=(P(axis_name, None, None), P(axis_name, None),
                   P(axis_name, None), P(axis_name, None)))
    xs, accs, sw_acc, sw_att = sharded(dev_keys)

    draws = common.finalize_draws(xs[K - 1], prob)
    n_accept = accs[K - 1].sum()
    # pair k's stats live on its left device k
    swap_rate = sw_acc[:-1].sum(axis=1) / jnp.maximum(sw_att[:-1].sum(axis=1), 1.0)
    return SamplerResult(
        draws=draws,
        n_accept_draws=n_accept,
        diagnostics={"temperatures": temps,
                     "swap_accept_rate": swap_rate},
    )
