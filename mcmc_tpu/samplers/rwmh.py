"""Random-walk Metropolis-Hastings.

Accelerator-native re-design of reference src/rwmh.cpp:30-199: the per-draw loop is a
:func:`jax.lax.scan` of a pure transition kernel, vmapped over chains. The
proposal is the Gaussian random walk ``z* = z + par_scale * chol(cov) @ xi``
(reference src/rwmh.cpp:113,122-123) and the accept test is
``log u < min(0, delta_logK)`` (src/rwmh.cpp:133-136) with non-finite
proposal log-kernels forced to -inf (src/rwmh.cpp:127-129).

Extensions (no reference analog):
- ``adapt_scale=True`` tunes the proposal scale by dual averaging toward the
  optimal 0.234 acceptance rate during burn-in, freezing the averaged
  iterate afterwards.
- ``adapt_precond=True`` learns a diagonal proposal covariance from windowed
  Welford estimates of the posterior variance (the same Stan-style doubling
  schedule as NUTS mass adaptation); dual averaging restarts at window ends.
  Requires the default identity ``cov_mat``.
- ``delayed_rejection=True`` adds a second-stage proposal after a
  first-stage rejection (Mira 2001; with ``adapt_precond='dense'`` this is
  DRAM, Haario-Laine-Mira-Saksman 2006): the fallback move is the same
  walk shrunk by ``dr_shrink`` (default 0.2), accepted with the exact
  two-stage ratio — because both stages share the proposal Cholesky, the
  Gaussian-density terms reduce to noise-space norms
  ``|s1 z1 - s2 z2|^2/s1^2 - |z1|^2`` and cost no solves. Batched, the
  second stage runs lockstep every draw (masked where stage one
  accepted): one extra kernel evaluation per draw buys a chain that keeps
  moving when the learned scale overshoots locally.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_tpu import adaptation
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import RWMHSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["rwmh", "RWMHState", "build_rwmh_kernel"]


class RWMHState(NamedTuple):
    position: jax.Array   # unconstrained coordinates, (n_vals,)
    log_prob: jax.Array   # box log-kernel at position
    da: adaptation.DualAveraging
    wv: adaptation.WindowedVariance   # proposal-covariance adaptation (diag)
    pchol: jax.Array      # chol of the dense proposal covariance ((1,) diag)
    pm2: jax.Array        # dense outer-product accumulator ((1,) diag mode)
    draw_ind: jax.Array


def build_rwmh_kernel(box_log_kernel, prop_chol_mv, par_scale,
                      adapt_cfg=None, precond_cfg=None, dr_shrink=None):
    """Single-chain transition kernel ``(key, state) -> (state, info)``.

    ``adapt_cfg`` is ``None`` (fixed scale, reference behavior) or a dict
    with ``n_burnin`` and ``target`` for dual-averaging scale adaptation.
    ``precond_cfg`` is ``None`` or a dict with ``n_adapt``, ``collect`` /
    ``window_end`` schedule masks, and ``axis_name`` (cross-chain pooling)
    for windowed diagonal proposal-covariance adaptation.
    """

    dense = precond_cfg is not None and precond_cfg.get("mode") == "dense"

    def init(position):
        dim = position.shape[0]
        dt = position.dtype
        return RWMHState(
            position=position,
            log_prob=box_log_kernel(position),
            da=adaptation.da_init(jnp.asarray(par_scale, dt)),
            wv=adaptation.wv_init(dim, dt),
            pchol=jnp.eye(dim, dtype=dt) if dense else jnp.ones((1,), dt),
            pm2=jnp.zeros((dim, dim), dt) if dense else jnp.ones((1,), dt),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    def step(key, state: RWMHState):
        k_noise, k_accept, k_noise2, k_accept2 = jax.random.split(key, 4)
        if adapt_cfg is None:
            scale = par_scale
        else:
            adapting = state.draw_ind < adapt_cfg["n_burnin"]
            scale = jnp.exp(jnp.where(adapting, state.da.log_eps,
                                      state.da.log_eps_bar))

        def chol_mv(v):
            if precond_cfg is None:
                return prop_chol_mv(v)
            if dense:
                return state.pchol @ v
            return jnp.sqrt(state.wv.var) * v

        noise = jax.random.normal(k_noise, state.position.shape, state.position.dtype)
        scaled = chol_mv(noise)
        proposal = state.position + scale * scaled

        prop_lp = box_log_kernel(proposal)
        prop_lp = jnp.where(jnp.isfinite(prop_lp), prop_lp, -jnp.inf)

        comp = jnp.minimum(0.0, prop_lp - state.log_prob)
        u = jax.random.uniform(k_accept, dtype=state.position.dtype)
        accepted = u < jnp.exp(comp)

        new_position = jnp.where(accepted, proposal, state.position)
        new_lp = jnp.where(accepted, prop_lp, state.log_prob)

        if dr_shrink is not None:
            # second-stage (delayed-rejection) move, lockstep every draw:
            # y2 = x + s2 C z2, s2 = dr_shrink * s1. Mira (2001) ratio for
            # symmetric shared-Cholesky stages — q1 terms in noise space:
            # log q1(y2->y1) - log q1(x->y1)
            #   = -(|s1 z1 - s2 z2|^2 / s1^2 - |z1|^2) / 2
            dt = state.position.dtype
            s2 = jnp.asarray(dr_shrink, dt) * scale
            z2 = jax.random.normal(k_noise2, state.position.shape, dt)
            y2 = state.position + s2 * chol_mv(z2)
            y2_lp = box_log_kernel(y2)
            y2_lp = jnp.where(jnp.isfinite(y2_lp), y2_lp, -jnp.inf)

            diffz = scale * noise - s2 * z2
            qdiff = -0.5 * (diffz @ diffz / (scale * scale)
                            - noise @ noise)
            # log(1 - alpha1(a -> y1)) = log1p(-exp(min(0, lp1 - lp_a))):
            # exactly -inf when alpha1 = 1 — correct (zero weight) in the
            # numerator; in the denominator it can only hit -inf by f32
            # rounding (a rejected stage one implies alpha1 < 1), in which
            # case the ratio is meaningless and stage two must reject.
            c_num = jnp.minimum(0.0, prop_lp - y2_lp)
            c_den = comp
            log_a2 = (y2_lp + qdiff + jnp.log1p(-jnp.exp(c_num))) \
                - (state.log_prob + jnp.log1p(-jnp.exp(c_den)))
            log_a2 = jnp.where(jnp.isnan(log_a2) | (c_den >= 0.0)
                               | ~jnp.isfinite(jnp.log1p(-jnp.exp(c_den))),
                               -jnp.inf, log_a2)
            u2 = jax.random.uniform(k_accept2, dtype=dt)
            accepted2 = (~accepted) & (
                jnp.log(u2) < jnp.minimum(0.0, log_a2))
            new_position = jnp.where(accepted2, y2, new_position)
            new_lp = jnp.where(accepted2, y2_lp, new_lp)
            accepted = accepted | accepted2

        da = state.da
        if adapt_cfg is not None:
            accept_stat = jnp.exp(comp)
            accept_stat = jnp.where(jnp.isnan(accept_stat), 0.0, accept_stat)
            da_new = adaptation.da_update(da, accept_stat, adapt_cfg["target"])
            da = jax.tree_util.tree_map(
                lambda new, old: jnp.where(adapting, new, old), da_new, da)

        wv = state.wv
        pchol, pm2 = state.pchol, state.pm2
        if precond_cfg is not None and not dense:
            wv, da = adaptation.windowed_precond_step(
                wv, da, new_position, state.draw_ind, precond_cfg,
                reset_da=adapt_cfg is not None)
        elif dense:
            # the adopted covariance itself is discarded (only its Cholesky
            # drives the proposal), hence the zeros placeholder
            wv, da, _cov, pchol, pm2 = adaptation.windowed_dense_step(
                state.wv, da, jnp.zeros_like(pm2), pchol, pm2,
                new_position, state.draw_ind, precond_cfg,
                reset_da=adapt_cfg is not None)

        new_state = RWMHState(
            position=new_position,
            log_prob=new_lp,
            da=da,
            wv=wv,
            pchol=pchol,
            pm2=pm2,
            draw_ind=state.draw_ind + 1,
        )
        return new_state, {"accepted": accepted}

    return init, step


def rwmh(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
         mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
         adapt_scale=False, adapt_precond=False, pooled_adaptation=False,
         target_accept=None, delayed_rejection=False, thin=1,
         return_resume=False) -> SamplerResult:
    """Run RWMH. ``log_kernel(params) -> scalar`` is a pure JAX function
    (closures replace the reference's ``void* target_data``).

    With ``n_chains`` set, ``initial_vals`` may be ``(n_vals,)`` (broadcast)
    or ``(n_chains, n_vals)``; draws come back as
    ``(n_keep, n_chains, n_vals)``. ``adapt_scale=True`` tunes the proposal
    scale during burn-in (target acceptance 0.234 unless overridden);
    ``adapt_precond=True`` (or ``"diag"`` / ``"dense"``) additionally
    learns a diagonal or full proposal covariance (see module docstring),
    pooled across chains when ``pooled_adaptation``.
    ``delayed_rejection=True`` adds the second-stage fallback proposal
    (``dr_shrink``-scaled; module docstring) — with
    ``adapt_precond='dense'`` this is DRAM; the reported ``accept_rate``
    counts either stage, while scale adaptation still targets the
    FIRST-stage acceptance (the scale governs stage one).
    ``return_resume=True`` attaches ``diagnostics["resume"](key, n_keep)``
    — a warm continuation from the final kernel state (adapted scale /
    proposal covariance carry over); incompatible with ``checkpoint_dir``.
    """
    algo, s = resolve_settings(settings, "rwmh_settings", RWMHSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains, dtype)
    cov = common.make_spd(s.cov_mat, prob.n_vals, prob.dtype)
    if adapt_precond and s.cov_mat is not None:
        raise ValueError("adapt_precond is incompatible with a user cov_mat "
                         "— the proposal covariance is learned")

    adapt_cfg = None
    if adapt_scale:
        adapt_cfg = {
            "n_burnin": s.n_burnin_draws,
            "target": target_accept or adaptation.TARGET_ACCEPT["rwmh"],
        }
    precond_cfg = None
    if adapt_precond:
        mode = {True: "diag"}.get(adapt_precond, adapt_precond)
        if mode not in ("diag", "dense"):
            raise ValueError(f"adapt_precond must be False/True/'diag'/"
                             f"'dense', got {adapt_precond!r}")
        precond_cfg = adaptation.make_precond_cfg(
            s.n_burnin_draws, pooled_adaptation, common.CHAIN_AXIS_NAME)
        precond_cfg["mode"] = mode
    init, step = build_rwmh_kernel(
        prob.box_log_kernel, cov.sqrt_mv, s.par_scale, adapt_cfg,
        precond_cfg, dr_shrink=s.dr_shrink if delayed_rejection else None)
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
        if adapt_scale:
            diagnostics["adapted_scale"] = jnp.exp(final_state.da.log_eps_bar)
        if adapt_precond:
            diagnostics["proposal_var"] = final_state.wv.var \
                if precond_cfg["mode"] == "diag" else \
                final_state.pchol @ jnp.swapaxes(final_state.pchol, -1, -2)
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {k: v[0] for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
