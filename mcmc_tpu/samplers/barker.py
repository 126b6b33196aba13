"""Barker proposal MCMC — robust gradient-based Metropolis.

No reference analog — this is the modern robust alternative to MALA
(reference src/mala.cpp:30-235): Livingstone & Zanella (2022, JRSS-B, "The
Barker proposal: combining robustness and efficiency in gradient-based
MCMC"). Where MALA moves the whole proposal mean by the drift
``eps^2/2 · grad`` — and diverges when the step size overshoots a light
tail — the Barker proposal uses the gradient only to *skew the sign* of a
symmetric per-coordinate kick:

    z_i ~ N(0, (eps·s_i)^2),   y_i = x_i + b_i·z_i,
    P(b_i = +1) = sigmoid(z_i · g_i(x)),   g = grad log pi

so the proposal never travels further than its Gaussian envelope. The
resulting chain inherits random-walk-like geometric ergodicity for targets
where MALA is transient, while keeping gradient-informed direction — its
efficiency degrades only ~2x vs a perfectly tuned MALA but is *insensitive*
to step-size mis-tuning, which makes it the right default inside adaptive
warmup where early step sizes are wrong by orders of magnitude.

MH correction (the Gaussian envelopes cancel; only the skew factors remain):

    log alpha = pi(y) - pi(x)
              + sum_i [softplus(-d_i·g_i(x)) - softplus(d_i·g_i(y))],
    d = y - x

Accelerator-native design: everything is element-wise vector work — one fused
``value_and_grad`` per draw (the current point's gradient rides in the chain
state, as in samplers/mala.py), a Bernoulli sign flip, and a softplus
correction; no linear algebra at all. Composes with the standard driver
stack: vmapped chains, ``mesh`` sharding, ``thin``, ``checkpoint_dir``,
``return_resume``, dual-averaged step size (target acceptance 0.574 — the
Barker efficiency curve is flat in the 0.4-0.7 range, Vogrinc, Livingstone
& Zanella 2022, so the exact target matters little; that flatness is the
robustness) and windowed diagonal preconditioning (per-coordinate proposal
scales ``s_i`` from pooled posterior variances).

Bounded problems use the exact box gradient (``grad [logK∘inv_transform +
log|J|]``) — there is no reference quirk to reproduce here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_tpu import adaptation
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import BarkerSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["barker", "BarkerState", "build_barker_kernel"]


class BarkerState(NamedTuple):
    position: jax.Array
    log_prob: jax.Array
    grad: jax.Array      # box gradient at position
    da: adaptation.DualAveraging
    wv: adaptation.WindowedVariance   # diagonal proposal-scale adaptation
    draw_ind: jax.Array


def build_barker_kernel(prob: common.Problem, step_size,
                        adapt_cfg=None, precond_cfg=None):
    """Pure single-chain Barker transition ``(key, state) -> (state, info)``."""
    box_vg = jax.value_and_grad(prob.box_log_kernel)
    adapt_m = precond_cfg is not None

    def init(position):
        lp, grad = box_vg(position)
        dt = position.dtype
        return BarkerState(
            position=position,
            log_prob=jnp.where(jnp.isfinite(lp), lp, -jnp.inf),
            grad=jnp.where(jnp.isfinite(grad), grad, 0.0),
            da=adaptation.da_init(jnp.asarray(step_size, dt)),
            wv=adaptation.wv_init(position.shape[0], dt),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    def step(key, state: BarkerState):
        k_noise, k_sign, k_accept = jax.random.split(key, 3)
        dt = state.position.dtype
        if adapt_cfg is None:
            eps = jnp.asarray(step_size, dt)
        else:
            adapting = state.draw_ind < adapt_cfg["n_burnin"]
            eps = jnp.exp(jnp.where(adapting, state.da.log_eps,
                                    state.da.log_eps_bar))
        scale = eps * jnp.sqrt(state.wv.var) if adapt_m else eps

        z = scale * jax.random.normal(k_noise, state.position.shape, dt)
        # P(b=+1) = sigmoid(z*g); flip via u < sigmoid is one uniform per dim
        u = jax.random.uniform(k_sign, state.position.shape, dt)
        b = jnp.where(u < jax.nn.sigmoid(z * state.grad), 1.0, -1.0)
        d = b * z
        proposal = state.position + d

        prop_lp, prop_grad = box_vg(proposal)
        prop_lp = jnp.where(jnp.isfinite(prop_lp), prop_lp, -jnp.inf)
        prop_grad = jnp.where(jnp.isfinite(prop_grad), prop_grad, 0.0)

        adj = (jax.nn.softplus(-d * state.grad)
               - jax.nn.softplus(d * prop_grad)).sum()
        comp = jnp.minimum(0.0, prop_lp - state.log_prob + adj)
        comp = jnp.where(jnp.isnan(comp), -jnp.inf, comp)
        accepted = jnp.log(jax.random.uniform(k_accept, dtype=dt)) < comp

        new_position = jnp.where(accepted, proposal, state.position)

        da = state.da
        if adapt_cfg is not None:
            accept_stat = jnp.exp(comp)
            da_new = adaptation.da_update(da, accept_stat,
                                          adapt_cfg["target"])
            da = jax.tree_util.tree_map(
                lambda new, old: jnp.where(adapting, new, old), da_new, da)

        wv = state.wv
        if adapt_m:
            wv, da = adaptation.windowed_precond_step(
                wv, da, new_position, state.draw_ind, precond_cfg,
                reset_da=adapt_cfg is not None)

        new_state = BarkerState(
            position=new_position,
            log_prob=jnp.where(accepted, prop_lp, state.log_prob),
            grad=jnp.where(accepted, prop_grad, state.grad),
            da=da, wv=wv,
            draw_ind=state.draw_ind + 1,
        )
        return new_state, {"accepted": accepted}

    return init, step


def barker(initial_vals, log_kernel, settings=None, *, n_chains=None,
           key=None, mesh=None, checkpoint_dir=None, checkpoint_every=500,
           dtype=None, adapt_step_size=False, adapt_precond=False,
           pooled_adaptation=False, target_accept=None, thin=1,
           return_resume=False) -> SamplerResult:
    """Run the Barker proposal sampler (module docstring).

    ``adapt_step_size=True`` dual-averages the global scale toward 0.574
    acceptance during burn-in; ``adapt_precond=True`` learns per-coordinate
    proposal scales from windowed Welford variances (Stan-style schedule),
    pooled across chains with ``pooled_adaptation``. ``return_resume=True``
    attaches ``diagnostics["resume"](key, n_keep)``; incompatible with
    ``checkpoint_dir``."""
    algo, s = resolve_settings(settings, "barker_settings", BarkerSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype)

    adapt_cfg = None
    if adapt_step_size:
        adapt_cfg = {
            "n_burnin": s.n_burnin_draws,
            "target": target_accept
            or adaptation.TARGET_ACCEPT["barker"],
        }
    precond_cfg = None
    if adapt_precond:
        precond_cfg = adaptation.make_precond_cfg(
            s.n_burnin_draws, pooled_adaptation, common.CHAIN_AXIS_NAME)

    init, step = build_barker_kernel(prob, s.step_size, adapt_cfg,
                                     precond_cfg)
    state0 = jax.vmap(init, axis_name=common.CHAIN_AXIS_NAME)(prob.first_draw)

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
        if adapt_step_size:
            diagnostics["adapted_step_size"] = jnp.exp(
                final_state.da.log_eps_bar)
        if adapt_precond:
            diagnostics["precond_var"] = final_state.wv.var
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {k: v[0] for k, v in diagnostics.items()}
        if thin > 1:
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
