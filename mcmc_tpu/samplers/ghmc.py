"""Generalized HMC with persistent momentum (Horowitz 1991).

No reference analog (beyond-reference extension; the reference's HMC,
src/hmc.cpp:30-254, fully refreshes momentum every draw). GHMC replaces
the full refresh with a partial one,

    p' = alpha * p + sqrt(1 - alpha^2) * chol(M) xi ,    xi ~ N(0, I)

followed by ONE short leapfrog trajectory and a Metropolis test that
NEGATES the momentum on rejection (the flip is what makes the kernel
exactly invariant; Horowitz 1991, "A generalized guided Monte Carlo
algorithm"). With ``alpha`` close to 1 the chain behaves like a single
long HMC trajectory chopped into accept/reject-able segments: one
gradient evaluation per draw (MALA's cost) with HMC-like coherent
motion — the kernel family underlying MEADS (Hoffman & Sountsov 2022,
AISTATS). Rejections reverse the motion, so GHMC wants a HIGH target
acceptance (default 0.95 here vs 0.8 for HMC) and a small step size.

Accelerator-first: like MALA/Barker, the whole transition is a handful of vector
ops plus one gradient — no tree, no lockstep straggler tax — so draws
vectorize perfectly across thousands of chains. Per-chain step-size
jitter (``jitter``) desynchronizes the periodic resonances that plague
fixed-step partial-refresh chains (the MEADS prescription) at zero cost.

Defaults: ``alpha`` is derived from the damping form
``alpha = exp(-step_size / L)`` when ``momentum_persistence`` is left at
0.0 (auto), with decoherence length ``L = sqrt(dim)`` — matching the
microcanonical family's auto-L convention (samplers/mclmc.py).

Tuning note: on the 100-d flagship the bench protocol is
``n_leap_steps=3``, ``thin=4``, ``momentum_persistence=0.98`` at the 0.95
accept target (benchmarks/ghmc_probe.py sweeps the alternatives; its
min-ESS/s on the GPU is not measured yet). Under-warmed persistent chains
are fragile: budget warmup in TRANSITIONS (burn-in draws x thin), not kept
draws.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_tpu import adaptation, integrators
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import GHMCSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["ghmc", "GHMCState", "build_ghmc_kernel"]


class GHMCState(NamedTuple):
    position: jax.Array     # unconstrained coordinates
    potential: jax.Array    # U = -box_log_kernel(position)
    momentum: jax.Array     # persistent momentum, covariance M
    da: adaptation.DualAveraging
    draw_ind: jax.Array


def build_ghmc_kernel(box_log_kernel, grad_fn, precond: common.SPD,
                      step_size, alpha, n_leap_steps, jitter,
                      adapt_cfg=None):
    """Single-chain GHMC transition ``(key, state) -> (state, info)``.

    ``alpha`` in [0, 1) is the momentum persistence (0 = plain HMC with
    ``n_leap_steps`` steps); ``jitter`` in [0, 1) scales the step size
    uniformly in ``[(1-jitter) eps, eps]`` per draw per chain.
    ``adapt_cfg``: dual-averaging step-size tuning (n_burnin, target).
    """
    alpha = float(alpha)
    beta = (1.0 - alpha * alpha) ** 0.5

    def init(position):
        dt = position.dtype
        return GHMCState(
            position=position,
            potential=-box_log_kernel(position),
            momentum=jnp.zeros_like(position),
            da=adaptation.da_init(jnp.asarray(step_size, dt)),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    def step(key, state: GHMCState):
        dt = state.position.dtype
        k_mom, k_jit, k_accept = jax.random.split(key, 3)
        if adapt_cfg is None:
            eps = jnp.asarray(step_size, dt)
        else:
            adapting = state.draw_ind < adapt_cfg["n_burnin"]
            eps = jnp.exp(jnp.where(adapting, state.da.log_eps,
                                    state.da.log_eps_bar))
        if jitter > 0.0:
            eps = eps * (1.0 - jitter * jax.random.uniform(k_jit, dtype=dt))

        # partial momentum refresh (exact N(0, M) invariant mix)
        xi = jax.random.normal(k_mom, state.position.shape, dt)
        p = alpha * state.momentum + beta * precond.sqrt_mv(xi)
        prev_K = integrators.kinetic_energy(p, precond.inv_mv)

        new_pos, new_mom = integrators.leapfrog(
            grad_fn, precond.inv_mv, eps, n_leap_steps, state.position, p)

        prop_U = -box_log_kernel(new_pos)
        prop_U = jnp.where(jnp.isfinite(prop_U), prop_U, jnp.inf)
        prop_K = integrators.kinetic_energy(new_mom, precond.inv_mv)

        delta = -(prop_U + prop_K) + (state.potential + prev_K)
        comp = jnp.minimum(0.0, delta)
        accepted = jnp.log(jax.random.uniform(k_accept, dtype=dt)) < comp

        position = jnp.where(accepted, new_pos, state.position)
        potential = jnp.where(accepted, prop_U, state.potential)
        # Horowitz flip: the rejected move keeps the refreshed momentum
        # NEGATED — required for detailed balance of the persistent chain
        momentum = jnp.where(accepted, new_mom, -p)

        da = state.da
        if adapt_cfg is not None:
            accept_stat = jnp.minimum(1.0, jnp.exp(delta))
            accept_stat = jnp.where(jnp.isnan(accept_stat), 0.0, accept_stat)
            da_new = adaptation.da_update(da, accept_stat,
                                          adapt_cfg["target"])
            da = jax.tree_util.tree_map(
                lambda new, old: jnp.where(adapting, new, old), da_new, da)

        new_state = GHMCState(position=position, potential=potential,
                              momentum=momentum, da=da,
                              draw_ind=state.draw_ind + 1)
        return new_state, {"accepted": accepted, "energy_error": delta}

    return init, step


def ghmc(initial_vals, log_kernel, settings=None, *, n_chains=None,
         key=None, mesh=None, checkpoint_dir=None, checkpoint_every=500,
         dtype=None, bounded_grad="reference", adapt_step_size=True,
         target_accept=None, thin=1, return_resume=False) -> SamplerResult:
    """Run generalized HMC with persistent momentum (module docstring).

    One gradient evaluation per draw (``n_leap_steps=1`` default);
    ``momentum_persistence`` (settings) sets alpha, 0.0 = auto
    ``exp(-step_size/sqrt(dim))`` computed from the NOMINAL (initial)
    step size — if ``adapt_step_size`` moves eps far from it, set alpha
    explicitly (see the in-code note). ``adapt_step_size`` (default ON —
    GHMC is step-size-sensitive) dual-averages toward 0.95 acceptance;
    ``jitter`` desynchronizes per-chain step sizes. All the usual driver
    options compose (``n_chains``/``mesh``/``checkpoint_dir``/``thin``/
    ``return_resume``, bounds via the umbrella settings).
    """
    algo, s = resolve_settings(settings, "ghmc_settings", GHMCSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if not (0.0 <= float(s.momentum_persistence) < 1.0):
        raise ValueError(f"momentum_persistence must be in [0, 1), got "
                         f"{s.momentum_persistence}")
    if not (0.0 <= float(s.jitter) < 1.0):
        raise ValueError(f"jitter must be in [0, 1), got {s.jitter}")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype)
    precond = common.make_spd(s.precond_mat, prob.n_vals, prob.dtype)
    grad_fn = integrators.make_kick_grad(prob, bounded_grad)

    adapt_cfg = None
    if adapt_step_size:
        adapt_cfg = {
            "n_burnin": s.n_burnin_draws,
            "target": (adaptation.TARGET_ACCEPT["ghmc"]
                       if target_accept is None else target_accept),
        }

    alpha = float(s.momentum_persistence)
    if alpha == 0.0:
        # Auto-alpha is computed from the NOMINAL step_size. When
        # adapt_step_size=True dual averaging can move eps well below it,
        # so the damping form exp(-eps/sqrt(dim)) is only approximate in
        # that case — deliberately so: deriving alpha per-draw from the
        # adapted eps was measured to push persistence near 1 (the 0.95
        # accept target shrinks eps) and badly slow mixing. Users who
        # adapt the step size and care about the exact damping should
        # set momentum_persistence explicitly (bench.py uses 0.98).
        import math
        alpha = math.exp(-float(s.step_size) / math.sqrt(prob.n_vals))
    init, step = build_ghmc_kernel(
        prob.box_log_kernel, grad_fn, precond, s.step_size, alpha,
        int(s.n_leap_steps), float(s.jitter), adapt_cfg)
    state0 = jax.vmap(init)(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            key, state0, step, n_burnin, n_keep,
            collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin,
        )
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = {"momentum_persistence": alpha}
        if "energy_error" in infos:
            diagnostics["energy_error"] = infos["energy_error"]
        if adapt_step_size:
            diagnostics["adapted_step_size"] = jnp.exp(
                final_state.da.log_eps_bar)
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {
                k: (v[:, 0] if getattr(v, "ndim", 0) == 2 else
                    v[0] if getattr(v, "ndim", 0) == 1 else v)
                for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
