"""Mesh-sharded AEES: one ladder position per device, history over the interconnect.

The reference parallelizes the temperature ladder with OpenMP threads that
read the next-hotter chain's full history from shared memory
(reference src/aees.cpp:166-247, 196-222). The multi-chip design
(SURVEY.md §2d "ladder parallelism", BASELINE north star "equi-energy ring
swaps become all-gather/permute collectives"):

- ladder position ``k`` lives on mesh device ``k``;
- after every draw, each device ``ppermute``s its new state and kernel value
  one step down the ladder (k -> k+1) over the interconnect, and the receiver appends it
  to a device-local copy of its hotter chain's history — the only
  cross-chain traffic is one (dim + 1)-float ring transfer per draw;
- the equi-energy ring construction and jump then read purely local memory.

Semantics note: all ladder positions advance simultaneously, so chain k sees
its hotter chain's history up to draw t-1 (a one-draw delay). The reference's
OpenMP loop has the same property up to scheduling races
(src/aees.cpp:166-169); here it is deterministic. The ring window is
therefore [begin, t-1] instead of the sequential [begin, t].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import AEESSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers.aees import (
    make_mh_step, make_ee_jump, make_temps, safe_initial_kv)
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["aees_sharded"]


def aees_sharded(initial_vals, log_kernel, settings=None, *, mesh: Mesh,
                 key=None, history_capacity=None, dtype=None,
                 axis_name: str = "chains") -> SamplerResult:
    """Run AEES with the temperature ladder sharded over ``mesh``.

    Requires ``len(temper_vec) + 1 == mesh size``. Returns the T = 1 chain's
    kept draws like :func:`mcmc_tpu.aees`.

    ``history_capacity=C`` replaces each device's full received-history
    buffer with a C-slot reservoir sample of the same window (algorithm R),
    making device memory and the per-EE-draw sort cost independent of the
    run length — see :mod:`mcmc_tpu.samplers.aees` (bounded-memory mode).
    """
    algo, s = resolve_settings(settings, "aees_settings", AEESSettings)
    key = resolve_key(key, algo)

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype)
    dim = prob.n_vals
    dt = prob.dtype
    box = prob.box_log_kernel

    temps = make_temps(s, dt)
    K = int(temps.shape[0])
    n_dev = mesh.shape[axis_name]
    if K != n_dev:
        raise ValueError(
            f"ladder size {K} (user temps + T=1) must equal mesh size {n_dev}"
        )

    block = s.n_initial_draws + s.n_burnin_draws
    n_total = s.n_keep_draws + K * block
    n_rings = int(s.n_rings)

    first = prob.first_draw[0]
    val_init = safe_initial_kv(box(first), dt)
    idx_all = jnp.arange(n_total)
    ring_perm = [(i, i + 1) for i in range(K - 1)]
    capped = history_capacity is not None
    H = int(history_capacity) if capped else n_total
    idx_slots = jnp.arange(H)

    # the single shared move implementations (samplers/aees.py)
    mh_step = make_mh_step(box, s, dim, dt)
    ee_jump = make_ee_jump(box, n_rings, dt)

    def ladder_run(dev_key):
        """Body per device (inside shard_map). dev_key: (1, 2) key slice."""
        k = lax.axis_index(axis_name)
        my_temp = temps[k]
        hotter_temp = temps[jnp.maximum(k - 1, 0)]
        begin = (jnp.maximum(k, 1) - 1) * block

        def ee_move(key_, draw_ind, x, cur_kv, kv2, hot_kv, hot_x):
            length = draw_ind - begin              # window [begin, draw_ind-1]
            avail = jnp.minimum(length, H) if capped else length
            spacing = avail // n_rings

            def jump(_):
                if capped:
                    mask = idx_slots < avail
                else:
                    mask = (idx_slots >= begin) & (idx_slots < draw_ind)
                xn, kvn, pairn, _acc = ee_jump(
                    key_, hot_kv, hot_x, mask, spacing,
                    x, cur_kv, kv2, hotter_temp, my_temp)
                return xn, kvn, pairn

            def stay(_):
                return x, cur_kv, kv2

            return lax.cond(spacing > 0, jump, stay, None)

        def body(carry, draw_ind):
            key_, x, cur_kv, kv2, hot_kv, hot_x = carry
            key_, k_sel, k_move, k_res = jax.random.split(key_, 4)

            def hottest(_):
                xn, vn = mh_step(k_move, x, cur_kv, my_temp)
                return xn, vn, jnp.array([vn, vn])

            def colder_active(_):
                def local(_):
                    xn, vn = mh_step(k_move, x, cur_kv, my_temp)
                    return xn, vn, jnp.array([vn / hotter_temp, vn / my_temp])

                def ee(_):
                    return ee_move(k_move, draw_ind, x, cur_kv, kv2,
                                   hot_kv, hot_x)

                z_eps = jax.random.uniform(k_sel, dtype=dt)
                return lax.cond(z_eps > s.ee_prob_par, local, ee, None)

            def colder(_):
                active = draw_ind > k * block
                return lax.cond(active, colder_active,
                                lambda _: (x, cur_kv, kv2), None)

            x_new, kv_new, pair_new = lax.cond(k == 0, hottest, colder, None)

            # ring transfer: my (state, kernel value) to the next-colder
            # device; entry 0 of the ring receives nothing meaningful.
            recv_kv = lax.ppermute(kv_new, axis_name, ring_perm)
            recv_x = lax.ppermute(x_new, axis_name, ring_perm)
            if not capped:
                hot_kv = hot_kv.at[draw_ind].set(recv_kv)
                hot_x = hot_x.at[draw_ind].set(recv_x)
            else:
                # reservoir (algorithm R) over the window [begin, draw_ind]
                t = draw_ind - begin + 1
                in_window = t >= 1
                k_u, k_slot = jax.random.split(k_res)
                u = jax.random.uniform(k_u, dtype=dt)
                rand_slot = jax.random.randint(k_slot, (), 0, H)
                accept_repl = u * t.astype(dt) < float(H)
                slot = jnp.where(t <= H, jnp.maximum(t - 1, 0), rand_slot)
                do = in_window & ((t <= H) | accept_repl)
                hot_kv = jnp.where(do, hot_kv.at[slot].set(recv_kv), hot_kv)
                hot_x = jnp.where(do, hot_x.at[slot].set(recv_x), hot_x)

            return (key_, x_new, kv_new, pair_new, hot_kv, hot_x), x_new

        # initial carry is built from axis-invariant constants but becomes
        # device-varying after one step; pcast marks it so lax.cond branch
        # types agree under the varying-axis checks of jax.shard_map
        carry0 = (
            dev_key[0],
            lax.pcast(first, axis_name, to='varying'),
            lax.pcast(val_init, axis_name, to='varying'),
            jnp.array([val_init / hotter_temp, val_init / my_temp]),
            lax.pcast(jnp.full((H,), val_init, dt), axis_name, to='varying'),
            lax.pcast(jnp.tile(first[None, :], (H, 1)), axis_name, to='varying'),
        )
        _, all_draws = lax.scan(body, carry0, idx_all)
        # every device returns its own draw trace; caller keeps ladder pos K-1
        return all_draws[None, K * block:]

    dev_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(K))
    sharded = shard_map(
        ladder_run, mesh=mesh,
        in_specs=(P(axis_name),),
        out_specs=P(axis_name, None, None),
    )
    draws_all = sharded(dev_keys)          # (K, n_keep, dim)
    draws = draws_all[K - 1]
    draws = common.finalize_draws(draws, prob)
    # the reference's AEES tracks no acceptance at all (aees_settings_t has
    # no n_accept_draws field); report the cold chain's kept-draw move count
    # — the draw changed iff a local or EE move was accepted
    moved = jnp.any(draws[1:] != draws[:-1], axis=-1).sum(axis=0)
    return SamplerResult(
        draws=draws,
        n_accept_draws=moved,
        diagnostics={"temperatures": temps},
    )
