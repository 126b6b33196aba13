"""Differential-evolution MCMC (population sampler, gradient-free).

Accelerator-native re-design of reference src/de.cpp:30-273: the population is a
first-class batch axis — every walker's proposal
``X_i + gamma (X_c1 - X_c2) + U[-b, b]`` (src/de.cpp:163-184) is formed and
evaluated in one vectorized step per generation, replacing the reference's
OpenMP loop over walkers (src/de.cpp:161-207). Cross-walker reads use the
*previous generation* snapshot — the reference's in-place row updates give
scheduling-dependent mixtures of old/new rows under OpenMP; the snapshot
semantics is the deterministic parallel limit (SURVEY.md §7 step 6) and is
what a mesh-sharded population all-gathers.

Reference semantics preserved:
- running gamma hard-coded to ``2.38 / sqrt(2 d)``; the ``par_gamma`` setting
  is ignored (src/de.cpp:59-60);
- with ``jumps``, every 10th generation uses ``par_gamma_jump``
  (src/de.cpp:151-153, 219-221);
- distinct indices ``c1 != i``, ``c2 not in {i, c1}`` — drawn here by
  shifted-uniform mapping, exact and shape-static;
- tempered accept ``delta_logK > T log u`` with the cooling schedule
  identically 1 (reference include/mcmc/de.hpp:84-89);
- the initial population is sampled uniformly in the (bounds-clipped) initial
  box and treated as unconstrained coordinates, exactly as the reference does
  (src/de.cpp:114-139 never transforms — kept for parity even though it
  mixes spaces when ``vals_bound``);
- acceptance counted over walkers post-burn-in into a single total
  (src/de.cpp:157-204).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import bounds as bounds_mod
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import DESettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["de", "DEState", "build_de_sweep", "de_cooling_schedule"]


def de_cooling_schedule(s, n_gen):
    """Identically 1 (reference include/mcmc/de.hpp:84-89, placeholder)."""
    return 1.0


class DEState(NamedTuple):
    X: jax.Array            # population, (n_pop, d), unconstrained coords
    kernel_vals: jax.Array  # (n_pop,)
    gen_ind: jax.Array      # generation counter (drives the jump cadence)


def _distinct_pair_indices(key, i, n_pop):
    """c1 uniform on {0..n_pop-1}\\{i}; c2 uniform on the rest \\ {c1}."""
    k1, k2 = jax.random.split(key)
    r1 = jax.random.randint(k1, (), 0, n_pop - 1)
    c1 = r1 + (r1 >= i)
    a = jnp.minimum(i, c1)
    b = jnp.maximum(i, c1)
    r2 = jax.random.randint(k2, (), 0, n_pop - 2)
    c2 = r2 + (r2 >= a)
    c2 = c2 + (c2 >= b)
    return c1, c2


def build_de_sweep(box_log_kernel, cfg: DESettings, n_vals: int):
    n_pop = cfg.n_pop
    par_gamma = 2.38 / math.sqrt(2.0 * n_vals)  # reference src/de.cpp:59-60
    batched_kernel = jax.vmap(box_log_kernel)

    def sweep(key, state: DEState):
        dtype = state.X.dtype
        k_idx, k_noise, k_acc = jax.random.split(key, 3)

        use_jump = cfg.jumps & ((state.gen_ind + 1) % 10 == 0)
        gamma_run = jnp.where(use_jump, cfg.par_gamma_jump, par_gamma).astype(dtype)

        idx = jnp.arange(n_pop)
        idx_keys = jax.random.split(k_idx, n_pop)
        c1, c2 = jax.vmap(_distinct_pair_indices, in_axes=(0, 0, None))(
            idx_keys, idx, n_pop
        )

        noise = jax.random.uniform(
            k_noise, (n_pop, n_vals), dtype, minval=-cfg.par_b, maxval=cfg.par_b
        )
        X_prop = state.X + gamma_run * (state.X[c1] - state.X[c2]) + noise

        prop_vals = batched_kernel(X_prop)
        prop_vals = jnp.where(jnp.isfinite(prop_vals), prop_vals, -jnp.inf)

        temperature = de_cooling_schedule(state.gen_ind, cfg.n_keep_draws)
        z = jax.random.uniform(k_acc, (n_pop,), dtype)
        accepted = (prop_vals - state.kernel_vals) > temperature * jnp.log(z)

        X_new = jnp.where(accepted[:, None], X_prop, state.X)
        kv_new = jnp.where(accepted, prop_vals, state.kernel_vals)
        new_state = DEState(X=X_new, kernel_vals=kv_new, gen_ind=state.gen_ind + 1)
        return new_state, {"accepted": accepted}

    return sweep


def de(initial_vals, log_kernel, settings=None, *, key=None, mesh=None,
       checkpoint_dir=None, checkpoint_every=500, dtype=None,
       thin=1) -> SamplerResult:
    """Run DE-MCMC. Returns draws of shape ``(n_keep, n_pop, n_vals)`` — the
    reference's ``Cube_t draws_out(n_pop, n_vals, n_keep)`` with the
    generation axis leading.

    With ``mesh``, the population is sharded across devices and each
    generation all-gathers the previous generation once over the interconnect
    (``mcmc_tpu.parallel.de_sharded``) — the multi-chip form of the
    reference's OpenMP walker loop (src/de.cpp:161-207).

    ``thin=k`` advances ``k`` generations per stored draw (burn-in and
    keep alike, the chain samplers' convention); ``n_accept_draws`` counts
    accepted moves over all ``n_keep * k`` kept-phase generations, and the
    every-10th-generation jump cadence counts generations, not rows."""
    algo, s = resolve_settings(settings, "de_settings", DESettings)
    key = resolve_key(key, algo)

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype)
    x0 = jnp.asarray(initial_vals, prob.dtype)
    dtype = x0.dtype
    n_vals = x0.shape[-1] if x0.ndim else x0.shape[0]

    init_lb = jnp.asarray(s.initial_lb, dtype) if s.initial_lb is not None else x0 - 0.5
    init_ub = jnp.asarray(s.initial_ub, dtype) if s.initial_ub is not None else x0 + 0.5
    init_lb, init_ub = bounds_mod.sampling_bounds_check(
        prob.vals_bound, prob.codes, prob.lower_bounds, prob.upper_bounds,
        init_lb, init_ub,
    )

    key, k_init = jax.random.split(key)
    U = jax.random.uniform(k_init, (s.n_pop, n_vals), dtype)
    X0 = init_lb + (init_ub - init_lb) * U
    kv0 = jax.vmap(prob.box_log_kernel)(X0)
    kv0 = jnp.where(jnp.isfinite(kv0), kv0, -jnp.inf)

    state0 = DEState(X=X0, kernel_vals=kv0, gen_ind=jnp.asarray(0, jnp.int32))

    if checkpoint_dir is not None:
        # restartable chunked execution; the unsharded sweep consumes one key
        # per generation (single_key), the sharded sweep per-walker keys —
        # both conventions match the in-memory paths below bit-for-bit
        from mcmc_tpu.checkpoint import ChunkedRunner
        if mesh is None:
            step, single = build_de_sweep(prob.box_log_kernel, s, n_vals), True
        else:
            from mcmc_tpu.parallel.de_sharded import build_sharded_de_sweep
            step = build_sharded_de_sweep(prob.box_log_kernel, s, n_vals, mesh)
            single = False
        step = common.thin_step(step, thin, batched=not single)
        runner = ChunkedRunner(step, collect_fn=lambda st: st.X,
                               directory=checkpoint_dir, mesh=mesh,
                               single_key=single)
        _, draws, totals = runner.run(
            key, state0, n_draws=s.n_keep_draws, n_burnin=s.n_burnin_draws,
            chunk_size=checkpoint_every,
        )
        draws = common.finalize_draws(jnp.asarray(draws), prob)
        per_walker = jnp.asarray(totals["accepted"])
        return SamplerResult(
            draws=draws, n_accept_draws=per_walker.sum(),
            diagnostics=common.population_accept_diag_totals(
                per_walker, s.n_keep_draws, thin))

    if mesh is None:
        sweep = build_de_sweep(prob.box_log_kernel, s, n_vals)
        sweep = common.thin_step(sweep, thin)
        _, (draws, accepted) = common.make_population_runner(sweep)(
            state0, key, s.n_burnin_draws, s.n_keep_draws)
    else:
        from mcmc_tpu.parallel.de_sharded import build_sharded_de_sweep
        from mcmc_tpu.parallel.mesh import shard_chain_axis

        sweep = build_sharded_de_sweep(prob.box_log_kernel, s, n_vals, mesh)
        sweep = common.thin_step(sweep, thin, batched=True)
        walker_keys = jax.random.split(key, s.n_pop)
        state0 = DEState(
            X=shard_chain_axis(state0.X, mesh),
            kernel_vals=shard_chain_axis(state0.kernel_vals, mesh),
            gen_ind=state0.gen_ind,
        )
        walker_keys = shard_chain_axis(walker_keys, mesh)

        def run(state, keys):
            def body(carry, _):
                st, ks = carry
                pairs = jax.vmap(lambda k: jax.random.split(k, 2))(ks)
                st, info = sweep(pairs[:, 1], st)
                return (st, pairs[:, 0]), (st.X, info["accepted"])

            carry = (state, keys)
            if s.n_burnin_draws > 0:
                def body_burn(carry, _):
                    carry, _out = body(carry, None)
                    return carry, None
                carry, _ = lax.scan(body_burn, carry, None,
                                    length=s.n_burnin_draws)
            _, out = lax.scan(body, carry, None, length=s.n_keep_draws)
            return out

        draws, accepted = jax.jit(run)(state0, walker_keys)

    n_accept = accepted.sum()
    draws = common.finalize_draws(draws, prob)
    return SamplerResult(
        draws=draws, n_accept_draws=n_accept,
        diagnostics=common.population_accept_diag(accepted, thin))
