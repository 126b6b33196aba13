"""Hamiltonian Monte Carlo.

Accelerator-native re-design of reference src/hmc.cpp:30-254: fixed ``n_leap_steps``
leapfrog trajectories with a constant preconditioner M, momentum refreshed as
``chol(M) @ xi`` each draw, and MH acceptance
``log u < min(0.01, -(U* + K*) + (U + K))`` (src/hmc.cpp:188) — the
reference's 0.01 clamp (not 0) is preserved. Non-finite proposal potentials
are forced to +inf so they are always rejected (src/hmc.cpp:180-182).

Gradients come from :func:`jax.grad` of the user kernel, replacing the
reference's ``grad_out*`` out-parameter convention and its optional external
``autodiff`` library (reference README.md:290-402).

Extensions (no reference analog): dual-averaging step-size adaptation
(``adapt_step_size=True``) and windowed diagonal mass-matrix adaptation
(``adapt_mass_matrix=True``, sharing NUTS's Stan-style warmup schedule).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_tpu import adaptation
from mcmc_tpu import integrators
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import HMCSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["hmc", "HMCState", "build_hmc_kernel"]


class HMCState(NamedTuple):
    position: jax.Array      # unconstrained coordinates
    potential: jax.Array     # U = -box_log_kernel(position)
    da: adaptation.DualAveraging
    draw_ind: jax.Array
    inv_mass: jax.Array      # inverse mass: (d,) diag or (d, d) dense
    mass_chol: jax.Array     # chol of inv_mass (dense mode; (1,) otherwise)
    w_count: jax.Array       # Welford window accumulators
    w_mean: jax.Array
    w_m2: jax.Array          # (d,) diagonal or (d, d) outer-product


def build_hmc_kernel(box_log_kernel, grad_fn, precond: common.SPD,
                     step_size, n_leap_steps, adapt_cfg=None,
                     mass_cfg=None):
    """``adapt_cfg``: dual-averaging step-size tuning (n_burnin, target).
    ``mass_cfg``: windowed mass adaptation — dict with ``n_burnin``, the
    collect/window-end masks from
    :func:`mcmc_tpu.adaptation.window_schedule`, and ``mode`` ("diag" or
    "dense", mirroring NUTS). With mass adaptation on, the preconditioner
    must be identity (the mass is learned)."""
    adapt_mass = mass_cfg is not None
    mass_mode = mass_cfg.get("mode", "diag") if adapt_mass else None

    def kinetic(r, inv_mass):
        if mass_mode == "diag":
            return 0.5 * jnp.sum(r * r * inv_mass)
        if mass_mode == "dense":
            return 0.5 * r @ (inv_mass @ r)
        return integrators.kinetic_energy(r, precond.inv_mv)

    def init(position):
        dim = position.shape[0]
        dt = position.dtype
        if mass_mode == "dense":
            inv_mass0 = jnp.eye(dim, dtype=dt)
            chol0 = jnp.eye(dim, dtype=dt)
            w_m2_0 = jnp.zeros((dim, dim), dt)
        else:
            inv_mass0 = jnp.ones((dim,), dt)
            chol0 = jnp.ones((1,), dt)
            w_m2_0 = jnp.zeros((dim,), dt)
        return HMCState(
            position=position,
            potential=-box_log_kernel(position),
            da=adaptation.da_init(jnp.asarray(step_size, dt)),
            draw_ind=jnp.asarray(0, jnp.int32),
            inv_mass=inv_mass0,
            mass_chol=chol0,
            w_count=jnp.asarray(0, jnp.int32),
            w_mean=jnp.zeros((dim,), dt),
            w_m2=w_m2_0,
        )

    def step(key, state: HMCState):
        dtype = state.position.dtype
        k_mom, k_accept = jax.random.split(key)
        if adapt_cfg is None:
            eps = step_size
            adapting_eps = None
        else:
            adapting_eps = state.draw_ind < adapt_cfg["n_burnin"]
            eps = jnp.exp(jnp.where(adapting_eps, state.da.log_eps,
                                    state.da.log_eps_bar))

        inv_mass = state.inv_mass
        noise = jax.random.normal(k_mom, state.position.shape, dtype)
        if mass_mode == "diag":
            momentum = noise * jax.lax.rsqrt(inv_mass)
            inv_mv = lambda v: inv_mass * v
        elif mass_mode == "dense":
            # inv_mass = Sigma = L L^T; p = L^{-T} xi ~ N(0, Sigma^{-1})
            momentum = jax.scipy.linalg.solve_triangular(
                state.mass_chol.T, noise, lower=False)
            inv_mv = lambda v: inv_mass @ v
        else:
            momentum = precond.sqrt_mv(noise)
            inv_mv = precond.inv_mv
        prev_K = kinetic(momentum, inv_mass)

        new_pos, new_mom = integrators.leapfrog(
            grad_fn, inv_mv, eps, n_leap_steps, state.position, momentum,
        )

        prop_U = -box_log_kernel(new_pos)
        prop_U = jnp.where(jnp.isfinite(prop_U), prop_U, jnp.inf)
        prop_K = kinetic(new_mom, inv_mass)

        comp = jnp.minimum(0.01, -(prop_U + prop_K) + (state.potential + prev_K))
        u = jax.random.uniform(k_accept, dtype=dtype)
        accepted = u < jnp.exp(comp)

        position = jnp.where(accepted, new_pos, state.position)

        da = state.da
        if adapt_cfg is not None:
            accept_stat = jnp.minimum(1.0, jnp.exp(comp))
            accept_stat = jnp.where(jnp.isnan(accept_stat), 0.0, accept_stat)
            da_new = adaptation.da_update(da, accept_stat, adapt_cfg["target"])
            da = jax.tree_util.tree_map(
                lambda new, old: jnp.where(adapting_eps, new, old), da_new, da)

        inv_mass_out = state.inv_mass
        chol_out = state.mass_chol
        wc, wm, wv = state.w_count, state.w_mean, state.w_m2
        if adapt_mass:
            idx = jnp.minimum(state.draw_ind, mass_cfg["collect"].shape[0] - 1)
            in_warmup = state.draw_ind < mass_cfg["n_burnin"]
            collecting = in_warmup & mass_cfg["collect"][idx]
            window_end = in_warmup & mass_cfg["window_end"][idx]

            wc, wm, wv, inv_mass_out, chol_out = \
                adaptation.windowed_mass_update(
                    wc, wm, wv, inv_mass_out, chol_out, position,
                    collecting, window_end, mass_mode)
            if adapt_cfg is not None:
                # restart dual averaging around the current step at the new
                # metric (Stan-style)
                eps_now = jnp.exp(da.log_eps)
                da = adaptation.DualAveraging(
                    log_eps=da.log_eps,
                    log_eps_bar=jnp.where(window_end, da.log_eps, da.log_eps_bar),
                    h=jnp.where(window_end, 0.0, da.h),
                    t=jnp.where(window_end, 0.0, da.t),
                    mu=jnp.where(window_end, jnp.log(10.0 * eps_now), da.mu),
                )

        new_state = HMCState(
            position=position,
            potential=jnp.where(accepted, prop_U, state.potential),
            da=da,
            draw_ind=state.draw_ind + 1,
            inv_mass=inv_mass_out,
            mass_chol=chol_out,
            w_count=wc, w_mean=wm, w_m2=wv,
        )
        info = {"accepted": accepted, "energy_error": -(prop_U + prop_K) + (state.potential + prev_K)}
        return new_state, info

    return init, step


def hmc(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None, mesh=None, checkpoint_dir=None, checkpoint_every=500,
        dtype=None, bounded_grad="reference", adapt_step_size=False,
        target_accept=None, adapt_mass_matrix=False, thin=1,
        return_resume=False) -> SamplerResult:
    """Run HMC. See reference src/hmc.cpp and mcmc_structs.hpp:66-78 for the
    settings fields; ``bounded_grad`` selects the constrained-space gradient
    convention (see mcmc_tpu.integrators). ``adapt_step_size=True`` tunes
    the step size by dual averaging toward 0.8 acceptance during burn-in;
    ``adapt_mass_matrix=True`` (or ``"diag"`` / ``"dense"``) adds windowed
    mass-matrix adaptation, mirroring NUTS's modes (neither extension has a
    reference analog). ``return_resume=True`` attaches
    ``diagnostics["resume"](key, n_keep)`` — a warm continuation from the
    final kernel state; incompatible with ``checkpoint_dir``."""
    algo, s = resolve_settings(settings, "hmc_settings", HMCSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains, dtype)
    precond = common.make_spd(s.precond_mat, prob.n_vals, prob.dtype)
    grad_fn = integrators.make_kick_grad(prob, bounded_grad)

    adapt_cfg = None
    if adapt_step_size:
        adapt_cfg = {
            "n_burnin": s.n_burnin_draws,
            "target": target_accept or adaptation.TARGET_ACCEPT["hmc"],
        }
    mass_cfg = None
    if adapt_mass_matrix:
        if s.precond_mat is not None:
            raise ValueError("adapt_mass_matrix is incompatible with a user "
                             "precond_mat — the mass matrix is learned")
        mode = {True: "diag"}.get(adapt_mass_matrix, adapt_mass_matrix)
        if mode not in ("diag", "dense"):
            raise ValueError(f"adapt_mass_matrix must be False/True/'diag'/"
                             f"'dense', got {adapt_mass_matrix!r}")
        collect, window_end = adaptation.window_schedule(s.n_burnin_draws)
        mass_cfg = {"n_burnin": s.n_burnin_draws, "collect": collect,
                    "window_end": window_end, "mode": mode}
    init, step = build_hmc_kernel(
        prob.box_log_kernel, grad_fn, precond, s.step_size, s.n_leap_steps,
        adapt_cfg, mass_cfg,
    )
    state0 = jax.vmap(init)(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            key, state0, step, n_burnin, n_keep,
            collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin,
        )

        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = {}
        if "energy_error" in infos:
            diagnostics["energy_error"] = infos["energy_error"]
        if adapt_step_size:
            diagnostics["adapted_step_size"] = jnp.exp(
                final_state.da.log_eps_bar)
        if adapt_mass_matrix:
            diagnostics["inv_mass_diag"] = final_state.inv_mass
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            def _squeeze(k, v):
                if k == "inv_mass_diag":
                    return v[0]
                return v[:, 0] if v.ndim == 2 else v[0]
            diagnostics = {k: _squeeze(k, v) for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
