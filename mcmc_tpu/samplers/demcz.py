"""DE-MC(Z): differential evolution MCMC with an archive and snooker moves.

No reference analog — MCMCLib's DE-MCMC (reference src/de.cpp:30-273,
reproduced in samplers/de.py) needs a population at least comparable to the
dimension, because proposals are differences of *current* walkers.  DE-MC(Z)
(ter Braak & Vrugt 2008, Stat Comput 18:435-446) completes the family for the
small-population regime: difference vectors are drawn from an **archive Z of
past states**, so a handful of walkers (``n_pop`` as small as 4) sample
high-dimensional targets — the archive supplies the geometry the tiny
population cannot.  Two moves per walker per generation:

- **parallel direction** (prob ``1 - snooker_prob``):
  ``x* = x_i + gamma (Z_r1 - Z_r2) + U[-b, b]^d`` with the DE-optimal
  ``gamma = 2.38 / sqrt(2 d)`` (and, every 10th generation when ``jumps``,
  ``par_gamma_jump`` for mode-jumping, as in samplers/de.py);
- **snooker** (prob ``snooker_prob``): run along the line through ``x_i``
  and an archive anchor ``z``: with ``e = x_i - z`` and
  ``gamma_s ~ U(1.2, 2.2)``,
  ``x* = x_i + gamma_s ((Z_r1 - Z_r2) . e / |e|^2) e``, accepted with the
  extra Jacobian factor ``(|x* - z| / |x_i - z|)^(d-1)`` (the move is a
  scaling along ``e``; the factor is the density of the line-projection
  map — ter Braak & Vrugt 2008, eq. 4).

Sampling from *past* states only (the archive is appended every
``archive_stride`` generations, never read in the generation that writes it)
keeps every generation a valid MH update, and the diminishing-adaptation
argument of the paper gives ergodicity.

Accelerator-native design: each walker's proposal depends only on its own state and
the shared archive — there is **no cross-walker read of the current
generation at all** (unlike DE's ``X_c1 - X_c2``), so the population
vectorizes with zero collective traffic; both candidate moves are formed for
every walker (O(d) each) and selected by mask before the single batched
kernel evaluation.  The archive is a fixed-capacity device buffer: by default
it is sized to hold every appended generation exactly (the paper's growing
archive, bounded because the run length is known at trace time); an explicit
``archive_size`` turns it into a ring that overwrites the oldest entries —
the same bounded-memory discipline as the AEES reservoir history.  Index
draws use the shifted-uniform trick over the *filled* prefix, so shapes stay
static while the archive grows.

Output convention matches ``de``: draws ``(n_keep, n_pop, n_vals)``;
``n_accept_draws`` totals accepted moves over kept generations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_tpu import bounds as bounds_mod
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import DEMCZSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["demcz", "DEMCZState", "build_demcz_sweep"]


class DEMCZState(NamedTuple):
    X: jax.Array            # population, (n_pop, d), unconstrained coords
    kernel_vals: jax.Array  # (n_pop,)
    Z: jax.Array            # archive buffer, (capacity, d)
    m_total: jax.Array      # total states ever appended (filled = min(., C))
    gen_ind: jax.Array      # generation counter (jump cadence + stride)


def _distinct_triple(key, filled):
    """Three mutually distinct indices uniform on [0, filled); ``filled`` may
    be traced (shapes stay static — only values are dynamic)."""
    k1, k2, k3 = jax.random.split(key, 3)
    r1 = jax.random.randint(k1, (), 0, filled)
    r2 = jax.random.randint(k2, (), 0, filled - 1)
    r2 = r2 + (r2 >= r1)
    a = jnp.minimum(r1, r2)
    b = jnp.maximum(r1, r2)
    r3 = jax.random.randint(k3, (), 0, filled - 2)
    r3 = r3 + (r3 >= a)
    r3 = r3 + (r3 >= b)
    return r1, r2, r3


def build_demcz_sweep(box_log_kernel, cfg: DEMCZSettings, n_vals: int,
                      capacity: int):
    """Returns ``sweep(key, state) -> (state, info)`` — one generation:
    vectorized proposal/accept for every walker, then the (strided) archive
    append."""
    n_pop = int(cfg.n_pop)
    gamma_par = 2.38 / math.sqrt(2.0 * n_vals)
    gamma_jump = float(cfg.par_gamma_jump)
    batched_kernel = jax.vmap(box_log_kernel)

    def sweep(key, state: DEMCZState):
        dtype = state.X.dtype
        filled = jnp.minimum(state.m_total, capacity)
        k_idx, k_gs, k_choice, k_noise, k_acc = jax.random.split(key, 5)

        use_jump = cfg.jumps & ((state.gen_ind + 1) % 10 == 0)
        g_par = jnp.where(use_jump, gamma_jump, gamma_par).astype(dtype)

        idx_keys = jax.random.split(k_idx, n_pop)
        r1, r2, rz = jax.vmap(_distinct_triple, in_axes=(0, None))(
            idx_keys, filled)
        d1 = state.Z[r1] - state.Z[r2]                       # (n_pop, d)

        # parallel-direction candidate
        noise = jax.random.uniform(
            k_noise, (n_pop, n_vals), dtype, minval=-cfg.par_b,
            maxval=cfg.par_b)
        prop_par = state.X + g_par * d1 + noise

        # snooker candidate along e = x - z, gamma_s ~ U(1.2, 2.2)
        z = state.Z[rz]
        e = state.X - z
        ee = jnp.sum(e * e, axis=-1)
        ee_safe = jnp.maximum(ee, jnp.asarray(
            jnp.finfo(dtype).tiny, dtype))   # z == x_i -> proposal = x_i
        g_s = jax.random.uniform(k_gs, (n_pop,), dtype, minval=1.2,
                                 maxval=2.2)
        coef = g_s * jnp.sum(d1 * e, axis=-1) / ee_safe
        prop_snk = state.X + coef[:, None] * e
        ee_new = jnp.maximum(jnp.sum((prop_snk - z) ** 2, axis=-1),
                             jnp.asarray(jnp.finfo(dtype).tiny, dtype))
        log_jac_snk = 0.5 * (n_vals - 1) * (jnp.log(ee_new)
                                            - jnp.log(ee_safe))

        snooker = jax.random.uniform(k_choice, (n_pop,), dtype) \
            < cfg.snooker_prob
        prop = jnp.where(snooker[:, None], prop_snk, prop_par)
        log_jac = jnp.where(snooker, log_jac_snk, 0.0)

        prop_vals = batched_kernel(prop)
        prop_vals = jnp.where(jnp.isfinite(prop_vals), prop_vals, -jnp.inf)

        log_acc = prop_vals - state.kernel_vals + log_jac
        accepted = jnp.log(jax.random.uniform(k_acc, (n_pop,), dtype)) \
            < jnp.minimum(0.0, log_acc)
        # a snooker whose anchor z equals x_i degenerates to the identity
        # proposal (always MH-accepted); count it as a rejection so
        # acceptance statistics report actual movement — state-wise the
        # two are indistinguishable
        accepted = accepted & ~(snooker & (ee <= jnp.finfo(dtype).tiny))

        X_new = jnp.where(accepted[:, None], prop, state.X)
        kv_new = jnp.where(accepted, prop_vals, state.kernel_vals)

        # strided archive append (ring positions; read-before-write is safe —
        # this generation only ever read the pre-append buffer)
        do_append = (state.gen_ind + 1) % cfg.archive_stride == 0
        rows = (state.m_total + jnp.arange(n_pop)) % capacity
        Z_new = state.Z.at[rows].set(
            jnp.where(do_append, X_new, state.Z[rows]))
        m_new = state.m_total + jnp.where(do_append, n_pop, 0)

        new_state = DEMCZState(X=X_new, kernel_vals=kv_new, Z=Z_new,
                               m_total=m_new, gen_ind=state.gen_ind + 1)
        return new_state, {"accepted": accepted}

    return sweep


def demcz(initial_vals, log_kernel, settings=None, *, key=None, n_runs=None,
          mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
          thin=1, return_resume=False) -> SamplerResult:
    """Run DE-MC(Z) — archive-based differential evolution with snooker
    moves (ter Braak & Vrugt 2008).  The small-population member of the
    gradient-free family: ``n_pop`` can be far below the dimension because
    difference proposals are drawn from the archive of past states.

    ``initial_vals`` (shape ``(n_vals,)``) centers the initial box
    (``initial_lb``/``initial_ub`` default to ``initial_vals ± 0.5``, the
    ``de`` convention); the initial archive is ``n_initial_archive`` uniform
    draws from that box (default ``max(n_pop, 10 * n_vals)`` — the paper's
    guidance; it must span the space for the difference geometry to be
    full-rank), and the population starts as the archive's last ``n_pop``
    rows.  For bounded problems the box is sampled in constrained space and
    transformed — a clean design, deliberately not reproducing ``de``'s
    reference mixed-space init quirk (this sampler has no reference to be
    quirk-compatible with).

    Returns draws of shape ``(n_keep, n_pop, n_vals)``.  The population is
    deliberately tiny and archive reads are local, so the scale-out axis is
    **independent replicated runs**, not a sharded population: ``n_runs``
    vmaps that many replicas, each with its own initial archive (draws come
    back as ``(n_keep, n_runs * n_pop, n_vals)`` — walkers of different
    runs share no archive, so cross-run R-hat is honest, unlike the
    within-run walkers, which are coupled through the shared archive), and
    ``mesh`` shards the replica axis over devices (embarrassingly parallel,
    no collectives; requires ``n_runs``).

    ``thin=k`` advances ``k`` generations per stored draw (the chain
    samplers' convention; the jump cadence and archive stride count
    generations, not rows).  ``return_resume=True`` attaches
    ``diagnostics["resume"](key, n_keep)`` — a warm continuation carrying
    the archive (incompatible with ``checkpoint_dir``); the default
    archive capacity is sized for *this* run's generations, so a
    continuation that appends past it rolls over to ring semantics
    (oldest entries overwritten) — set ``archive_size`` to budget for
    continuations explicitly."""
    algo, s = resolve_settings(settings, "demcz_settings", DEMCZSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if mesh is not None and n_runs is None:
        raise ValueError(
            "mesh shards the replica axis — pass n_runs (the population "
            "itself is deliberately tiny and is not sharded)")
    if n_runs is not None and int(n_runs) < 1:
        raise ValueError(f"n_runs must be >= 1, got {n_runs}")
    n_runs = None if n_runs is None else int(n_runs)

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype)
    if not prob.squeeze:
        raise ValueError(
            f"demcz takes a single center point initial_vals of shape "
            f"(n_vals,); got a chain-batched array of shape "
            f"{tuple(jnp.shape(initial_vals))} — the population size is "
            f"DEMCZSettings.n_pop")
    n_vals, dt = prob.n_vals, prob.dtype
    n_pop = int(s.n_pop)
    if n_pop < 4:
        raise ValueError(f"n_pop must be >= 4, got {n_pop}")
    if not 0.0 <= float(s.snooker_prob) <= 1.0:
        raise ValueError(f"snooker_prob must be in [0, 1], "
                         f"got {s.snooker_prob}")
    if int(s.archive_stride) < 1:
        raise ValueError(f"archive_stride must be >= 1, "
                         f"got {s.archive_stride}")

    n_init = int(s.n_initial_archive) if s.n_initial_archive is not None \
        else max(n_pop, 10 * n_vals)
    if n_init < max(n_pop, 4):
        raise ValueError(
            f"n_initial_archive must be >= max(n_pop, 4), got {n_init}")
    # total GENERATIONS this run executes (thin advances thin generations
    # per stored draw — the archive stride counts generations)
    n_gens = (int(s.n_burnin_draws) + int(s.n_keep_draws)) * int(thin)
    if s.archive_size is not None:
        capacity = int(s.archive_size)
        if capacity < n_init:
            raise ValueError(
                f"archive_size={capacity} < n_initial_archive={n_init}")
    else:
        # paper-exact growing archive: capacity holds every append of THIS
        # run (known at trace time), so nothing is overwritten; a warm
        # continuation (return_resume) that runs past this sizing rolls
        # over to ring semantics, overwriting the oldest entries
        capacity = n_init + n_pop * (n_gens // int(s.archive_stride))

    x0_c = jnp.asarray(initial_vals, dt)   # constrained center for the box
    init_lb = jnp.asarray(s.initial_lb, dt) if s.initial_lb is not None \
        else x0_c - 0.5
    init_ub = jnp.asarray(s.initial_ub, dt) if s.initial_ub is not None \
        else x0_c + 0.5
    init_lb, init_ub = bounds_mod.sampling_bounds_check(
        prob.vals_bound, prob.codes, prob.lower_bounds, prob.upper_bounds,
        init_lb, init_ub)

    def init_state(k):
        U = jax.random.uniform(k, (n_init, n_vals), dt)
        Z_init = init_lb + (init_ub - init_lb) * U
        if prob.vals_bound:
            Z_init = jax.vmap(lambda v: bounds_mod.transform(
                v, prob.codes, prob.lower_bounds, prob.upper_bounds))(Z_init)
        Z0 = jnp.zeros((capacity, n_vals), dt).at[:n_init].set(Z_init)
        X0 = Z_init[-n_pop:]
        kv0 = jax.vmap(prob.box_log_kernel)(X0)
        kv0 = jnp.where(jnp.isfinite(kv0), kv0, -jnp.inf)
        return DEMCZState(X=X0, kernel_vals=kv0, Z=Z0,
                          m_total=jnp.asarray(n_init, jnp.int32),
                          gen_ind=jnp.asarray(0, jnp.int32))

    key, k_init = jax.random.split(key)
    if n_runs is None:
        state0 = init_state(k_init)
    else:
        # independent replicas: each run gets its own initial archive
        state0 = jax.vmap(init_state)(jax.random.split(k_init, n_runs))
        if mesh is not None:
            from mcmc_tpu.parallel.mesh import shard_chain_axis
            state0 = shard_chain_axis(state0, mesh)

    sweep = build_demcz_sweep(prob.box_log_kernel, s, n_vals, capacity)
    sweep = common.thin_step(sweep, thin)

    if checkpoint_dir is not None:
        from mcmc_tpu.checkpoint import ChunkedRunner
        if n_runs is None:
            runner = ChunkedRunner(sweep, collect_fn=lambda st: st.X,
                                   directory=checkpoint_dir, single_key=True)
        else:
            # replica-batched state; the runner derives one key per run
            runner = ChunkedRunner(jax.vmap(sweep),
                                   collect_fn=lambda st: st.X,
                                   directory=checkpoint_dir, mesh=mesh)
        _, draws, totals = runner.run(
            key, state0, n_draws=s.n_keep_draws, n_burnin=s.n_burnin_draws,
            chunk_size=checkpoint_every)
        draws = jnp.asarray(draws)
        per_walker = jnp.asarray(totals["accepted"])
        if n_runs is not None:
            draws = draws.reshape(draws.shape[0], n_runs * n_pop, n_vals)
            per_walker = per_walker.reshape(n_runs * n_pop)
        draws = common.finalize_draws(draws, prob)
        return SamplerResult(
            draws=draws, n_accept_draws=per_walker.sum(),
            diagnostics=common.population_accept_diag_totals(
                per_walker, s.n_keep_draws, thin))

    run_jit = common.make_population_runner(sweep)
    if n_runs is not None:
        vrun = jax.vmap(run_jit, in_axes=(0, 0, None, None))

    def assemble(key, state0, n_burnin, n_keep):
        if n_runs is None:
            final_state, (draws, accepted) = run_jit(state0, key, n_burnin,
                                                     n_keep)
        else:
            run_keys = jax.random.split(key, n_runs)
            if mesh is not None:
                from mcmc_tpu.parallel.mesh import shard_chain_axis
                run_keys = shard_chain_axis(run_keys, mesh)
            final_state, (draws, accepted) = vrun(state0, run_keys,
                                                  n_burnin, n_keep)
            # (n_runs, n_keep, n_pop, .) -> (n_keep, n_runs * n_pop, .):
            # walkers of different runs are fully independent chains
            draws = jnp.moveaxis(draws, 0, 1).reshape(
                n_keep, n_runs * n_pop, n_vals)
            accepted = jnp.moveaxis(accepted, 0, 1).reshape(
                n_keep, n_runs * n_pop)
        draws = common.finalize_draws(draws, prob)
        return SamplerResult(
            draws=draws, n_accept_draws=accepted.sum(),
            diagnostics=common.population_accept_diag(accepted, thin),
        ), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
