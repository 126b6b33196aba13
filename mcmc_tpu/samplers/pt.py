"""Parallel tempering (replica exchange) with HMC or RWMH inner moves.

No reference analog — MCMCLib's multimodal answer is AEES (reference
src/aees.cpp:30-305), whose equi-energy jumps *approximate* what replica
exchange does exactly: a ladder of K replicas targets the tempered densities
``pi_k(x) ∝ exp(beta_k * log_kernel(x))`` (``beta = 1/T``, descending
temperatures, the cold ``T = 1`` chain last, matching the AEES ladder
convention), and adjacent replicas periodically attempt to swap states with
the exact two-temperature Metropolis ratio

    log alpha_k = (beta_k - beta_{k+1}) * (logK(x_{k+1}) - logK(x_k)).

Accelerator-native design:

- the whole ladder is one ``(K, d)`` batch: inner moves are a single vmap
  over the ladder axis (K tempered HMC trajectories run as one batched
  leapfrog — matmul-friendly, no per-temperature loop);
- the even/odd swap phase is a masked index permutation of the ladder batch
  — zero host synchronization, zero gather/scatter: active non-overlapping
  pairs swap via one ``jnp.where`` on a permutation vector;
- each replica carries its *untempered* kernel value, so a swap round costs
  no kernel evaluations at all (the reference's AEES jump re-evaluates the
  kernel per jump, src/aees.cpp:243);
- the sampler is a pure ``(key, state) -> (state, info)`` kernel riding the
  standard scan driver: ``n_chains`` independent ladders vmap/shard over the
  chain axis and compose with ``mesh`` and ``checkpoint_dir`` like every
  other sampler. A ladder-sharded variant (one temperature per device, swaps
  over the interconnect via ``ppermute``) lives in ``mcmc_tpu.parallel.pt_sharded``.

**Ladder adaptation** (``adapt_temps=True``): Robbins-Monro stochastic
approximation on the log inverse-temperature spacings (Miasojedow, Moulines
& Vihola 2013): with ``log T_k = log T_{k+1} + exp(rho_k)`` (monotonicity is
structural — no ordering constraint to enforce), each attempted swap updates
``rho_k += gamma_t * (alpha_k - target_swap_accept)`` toward the classic
0.234 swap-acceptance target, with the swap probability pooled across the
vmapped chain axis (``lax.pmean`` — a psum over the interconnect when chains are
mesh-sharded). Adaptation freezes after ``n_adapt_draws`` (default: the
burn-in), keeping the kept phase a valid fixed-kernel MCMC run.

For bounded problems the tempered target is ``beta * box_log_kernel`` on the
unconstrained space (tempering includes the log-Jacobian, the standard
choice); the cold chain is exactly the usual box kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import integrators
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import PTSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["pt", "PTState", "build_pt_kernel", "make_ladder"]

_ADAPT_RATE = 0.25     # Robbins-Monro base step for rho updates
_ADAPT_DECAY = 0.6     # gamma_t = RATE / (1 + t)^DECAY over swap rounds


class PTState(NamedTuple):
    X: jax.Array         # (K, d) replica positions, cold chain last
    kv: jax.Array        # (K,) untempered log-kernel values
    rho: jax.Array       # (K-1,) log inverse-temperature spacings
    occ: jax.Array       # (K,) original-replica id occupying each rung
    odir: jax.Array      # (K,) per-ORIGINAL-replica flow state: 0 virgin,
                         # +1 touched hot (heading cold), -1 cold-after-hot
    trips: jax.Array     # (K,) per-original-replica completed round trips
    draw_ind: jax.Array  # global draw counter


def make_ladder(s: PTSettings, dt):
    """Initial descending temperature ladder: explicit ``temper_vec`` + T=1
    (the AEES convention), or geometric from ``max_temp`` down to 1 over
    ``n_temps`` rungs."""
    if s.temper_vec is not None:
        user = jnp.asarray(s.temper_vec, dt)
        if user.size and not bool(jnp.all(user > 1.0)):
            raise ValueError(
                "temper_vec entries must all be > 1 (temperatures, not "
                "inverse temperatures); T=1 is appended automatically and "
                "the coldest ladder slot must be the posterior chain")
        temps = jnp.sort(jnp.concatenate([user, jnp.ones((1,), dt)]))[::-1]
    else:
        K = int(s.n_temps)
        if K < 1:
            raise ValueError(f"n_temps must be >= 1, got {K}")
        expo = jnp.arange(K - 1, -1, -1, dtype=dt) / max(K - 1, 1)
        temps = jnp.asarray(s.max_temp, dt) ** expo
    if temps.shape[0] > 1 and not bool(jnp.all(temps[:-1] > temps[1:])):
        raise ValueError("temperature ladder must be strictly descending "
                         "after appending T=1 (duplicate temperatures?)")
    return temps


def make_inner_move(box, s: PTSettings, dim, dt):
    """Single-replica tempered inner move
    ``(key, x, kv, beta, temper) -> (x, kv, accepted)``.

    The ONE implementation of the tempered HMC / RWMH replica step, shared
    by the batched-ladder sampler below and the ladder-sharded variant
    (:mod:`mcmc_tpu.parallel.pt_sharded`), so accept semantics cannot
    diverge between the two."""
    inner = s.inner
    if inner not in ("hmc", "rwmh"):
        raise ValueError(f"inner must be 'hmc' or 'rwmh', got {inner!r}")
    grad_box = jax.grad(box) if inner == "hmc" else None
    cov = common.make_spd(s.cov_mat, dim, dt) if inner == "rwmh" else None

    def inner_hmc(key, x, kv, beta, temper):
        """One tempered HMC draw: U(z) = -beta*box(z), identity mass, step
        size scaled by sqrt(T) (hot replicas take proportionally longer
        steps over their flatter landscape)."""
        k_mom, k_acc = jax.random.split(key)
        eps = s.step_size * jnp.sqrt(temper)
        p0 = jax.random.normal(k_mom, (dim,), dt)
        z, p = integrators.leapfrog(
            lambda zz: beta * grad_box(zz), lambda m: m, eps,
            int(s.n_leap_steps), x, p0)
        kv_new = box(z)
        kv_safe = jnp.where(jnp.isfinite(kv_new), kv_new, -jnp.inf)
        dH = beta * (kv_safe - kv) - 0.5 * (p @ p - p0 @ p0)
        acc = jnp.log(jax.random.uniform(k_acc, dtype=dt)) < jnp.minimum(0.0, dH)
        return jnp.where(acc, z, x), jnp.where(acc, kv_safe, kv), acc

    def inner_rwmh(key, x, kv, beta, temper):
        k_n, k_u = jax.random.split(key)
        noise = jax.random.normal(k_n, (dim,), dt)
        prop = x + jnp.sqrt(temper) * s.par_scale * cov.sqrt_mv(noise)
        kv_new = box(prop)
        kv_safe = jnp.where(jnp.isfinite(kv_new), kv_new, -jnp.inf)
        comp = jnp.minimum(0.0, beta * (kv_safe - kv))
        acc = jnp.log(jax.random.uniform(k_u, dtype=dt)) < comp
        return jnp.where(acc, prop, x), jnp.where(acc, kv_safe, kv), acc

    return inner_hmc if inner == "hmc" else inner_rwmh


def _log_temps_from_rho(rho, dt):
    """(K-1,) spacings -> (K,) log-temperatures, cold (log T = 0) last."""
    spac = jnp.exp(rho)
    return jnp.concatenate(
        [jnp.cumsum(spac[::-1])[::-1], jnp.zeros((1,), dt)])


def build_pt_kernel(box, s: PTSettings, dim, dt, n_adapt,
                    axis_name=None):
    """Returns ``(make_state0, step)`` for the PT transition kernel.

    ``box`` is the (unconstrained-space) log kernel; ``n_adapt`` the number
    of leading draws during which the ladder adapts (0 disables)."""
    temps0 = make_ladder(s, dt)
    K = int(temps0.shape[0])
    adapt = bool(s.adapt_temps) and n_adapt > 0 and K > 1
    swap_every = max(int(s.swap_every), 1)
    inner_step = make_inner_move(box, s, dim, dt)
    pair_idx = jnp.arange(max(K - 1, 1))
    idx_K = jnp.arange(K)

    if K > 1:
        lt0 = jnp.log(temps0)
        rho0 = jnp.log(lt0[:-1] - lt0[1:])
    else:
        rho0 = jnp.zeros((0,), dt)

    def step(key, state: PTState):
        draw_ind = state.draw_ind
        if adapt:
            log_temps = _log_temps_from_rho(state.rho, dt)
        else:
            log_temps = jnp.log(temps0)
        temps = jnp.exp(log_temps)
        betas = jnp.exp(-log_temps)

        k_inner, k_swap = jax.random.split(key)
        inner_keys = jax.random.split(k_inner, K)
        X, kv, acc = jax.vmap(inner_step)(inner_keys, state.X, state.kv,
                                          betas, temps)
        info = {"accepted": acc[K - 1]}
        rho = state.rho
        occ, odir, trips = state.occ, state.odir, state.trips

        if K > 1:
            # even/odd swap round every `swap_every` sweeps: active pairs
            # (k, k+1) with k ≡ parity (mod 2) are non-overlapping, so the
            # swap is a single masked permutation of the ladder batch
            swap_round = draw_ind // swap_every
            do_round = (draw_ind % swap_every) == (swap_every - 1)
            parity = (swap_round % 2).astype(pair_idx.dtype)
            active = do_round & ((pair_idx % 2) == parity)

            log_alpha = (betas[:-1] - betas[1:]) * (kv[1:] - kv[:-1])
            u = jax.random.uniform(k_swap, (K - 1,), dt)
            acc_swap = active & (jnp.log(u) < jnp.minimum(0.0, log_alpha))

            with_next = jnp.concatenate(
                [acc_swap, jnp.zeros((1,), bool)])          # k takes k+1
            with_prev = jnp.concatenate(
                [jnp.zeros((1,), bool), acc_swap])          # k takes k-1
            perm = jnp.where(with_next, idx_K + 1,
                             jnp.where(with_prev, idx_K - 1, idx_K))
            X = X[perm]
            kv = kv[perm]
            occ = occ[perm]

            # replica-flow bookkeeping (Syed et al. 2022 round-trip rate):
            # a round trip is a completed hot->cold->hot traversal. Three
            # per-ORIGINAL-replica states (they follow the occupant through
            # swaps): 0 = never touched the hot end, +1 = touched hot,
            # heading cold, -1 = touched cold AFTER hot, heading back. A
            # virgin replica's first cold visit must not bank half a trip.
            cold_occ = occ[K - 1]
            hot_occ = occ[0]
            trips = trips.at[hot_occ].add(
                jnp.where(odir[hot_occ] < 0, 1, 0))
            odir = odir.at[hot_occ].set(1)
            odir = odir.at[cold_occ].set(
                jnp.where(odir[cold_occ] == 1, -1, odir[cold_occ]))

            info["swap_accepted"] = acc_swap.astype(dt)
            info["swap_attempted"] = active.astype(dt)

            if adapt:
                alpha = jnp.exp(jnp.minimum(0.0, log_alpha))
                if axis_name is not None:
                    alpha = lax.pmean(alpha, axis_name)
                gamma = _ADAPT_RATE / (1.0 + swap_round.astype(dt)) ** _ADAPT_DECAY
                upd = gamma * (alpha - s.target_swap_accept)
                adapting = active & (draw_ind < n_adapt)
                rho = jnp.where(adapting, rho + upd, rho)

        new_state = PTState(X=X, kv=kv, rho=rho, occ=occ, odir=odir,
                            trips=trips, draw_ind=draw_ind + 1)
        return new_state, info

    def make_state0(first, val_init):
        return PTState(
            X=jnp.tile(first[None, :], (K, 1)),
            kv=jnp.full((K,), val_init, dt),
            rho=jnp.asarray(rho0, dt),
            occ=jnp.arange(K, dtype=jnp.int32),
            odir=jnp.zeros((K,), jnp.int32),
            trips=jnp.zeros((K,), jnp.int32),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    return make_state0, step


def pt(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
       mesh=None, checkpoint_dir=None, checkpoint_every=500,
       dtype=None, thin=1, return_resume=False) -> SamplerResult:
    """Run parallel tempering. Returns the cold (T = 1) chain's kept draws,
    ``(n_keep, n_chains, n_vals)`` (chain axis squeezed when ``n_chains`` is
    None), like the other entry points.

    ``n_chains`` independent ladders run vmapped (sharded over ``mesh``);
    within a ladder the K replicas advance as one batched inner move plus a
    masked even/odd swap permutation — see the module docstring.

    Diagnostics: ``temperatures`` (the final ladder — adapted when
    ``adapt_temps=True``), ``swap_accept_rate`` (per adjacent pair, over
    kept draws), and the replica-flow measures ``round_trips`` /
    ``round_trip_rate`` (completed hot->cold->hot traversals per ladder
    over the whole run incl. burn-in, and per sweep — Syed et al. 2022;
    a ladder can show healthy pairwise swap rates while replicas never
    traverse it, which is exactly the failure this exposes; on a warm
    ``resume`` the counts stay cumulative while the denominator restarts,
    so compare rates only within one segment). ``return_resume=True``
    attaches
    ``diagnostics["resume"](key, n_keep)`` — a warm continuation from the
    final replica states (adapted ladder carries over); incompatible with
    ``checkpoint_dir``."""
    algo, s = resolve_settings(settings, "pt_settings", PTSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains, dtype)
    dim, dt, box = prob.n_vals, prob.dtype, prob.box_log_kernel

    n_adapt = s.n_adapt_draws if s.n_adapt_draws is not None \
        else s.n_burnin_draws
    make_state0, step = build_pt_kernel(
        box, s, dim, dt, int(n_adapt), axis_name=common.CHAIN_AXIS_NAME)
    K = make_state0(prob.first_draw[0], jnp.zeros((), dt)).X.shape[0]

    def init_one(first):
        kv0 = box(first)
        return make_state0(first, jnp.where(jnp.isfinite(kv0), kv0,
                                            -jnp.asarray(jnp.inf, dt)))

    state0 = jax.vmap(init_one)(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final, draws, infos = common.run_sampler_loop(
            key, state0, step, n_burnin, n_keep,
            collect_fn=lambda st: st.X[:, K - 1], mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin)

        draws = common.finalize_draws(draws, prob)
        n_accept = common.tally_accepts(infos)

        if K > 1:
            if "totals" in infos:
                acc_sum = jnp.asarray(infos["totals"]["swap_accepted"])
                att_sum = jnp.asarray(infos["totals"]["swap_attempted"])
            else:
                acc_sum = infos["swap_accepted"].sum(axis=0)
                att_sum = infos["swap_attempted"].sum(axis=0)
            swap_rate = acc_sum / jnp.maximum(att_sum, 1.0)  # (n_chains, K-1)
            if prob.squeeze:
                swap_rate = swap_rate[0]
        else:
            swap_rate = jnp.zeros((0,), dt)

        if s.adapt_temps and K > 1:
            # chain-pooled adaptation keeps every chain's ladder identical;
            # report chain 0's
            temps_final = jnp.exp(_log_temps_from_rho(final.rho[0], dt))
        else:
            temps_final = make_ladder(s, dt)

        # replica-flow efficiency (Syed, Bouchard-Côté et al. 2022): total
        # hot->cold->hot round trips per ladder over the WHOLE run
        # (burn-in included) and the per-sweep rate — the diagnostic that
        # distinguishes a ladder that merely swaps locally from one whose
        # replicas actually traverse it
        n_sweeps = (n_burnin + n_keep) * max(int(thin), 1)
        round_trips = final.trips.sum(axis=-1)             # (n_chains,)
        trip_rate = round_trips.astype(dt) / jnp.asarray(
            max(n_sweeps, 1), dt)
        if prob.squeeze:
            round_trips = round_trips[0]
            trip_rate = trip_rate[0]

        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]

        return SamplerResult(
            draws=draws,
            n_accept_draws=n_accept,
            diagnostics={"temperatures": temps_final,
                         "swap_accept_rate": swap_rate,
                         "round_trips": round_trips,
                         "round_trip_rate": trip_rate,
                         **({"thin": int(thin)} if thin > 1 else {})},
        ), final

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
