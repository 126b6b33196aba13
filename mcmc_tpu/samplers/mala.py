"""Metropolis-adjusted Langevin algorithm.

Accelerator-native re-design of reference src/mala.cpp:30-235 + include/mcmc/mala.ipp:
drift ``mu(z) = z + eps^2/2 * M * grad logK`` (src/mala.cpp:97-125), proposal
``mu + eps * chol(M) * xi`` (src/mala.cpp:149-160), and an MH correction with
the proposal-asymmetry term computed from two MVN log-densities
(mala.ipp:30-70). The reference's accept clamp ``min(0.01, .)``
(src/mala.cpp:170) and its quirk of using the *proposal's* inverse-Jacobian
in both asymmetry terms when bounded (mala.ipp:48-57) are preserved in
``bounded_grad="reference"`` mode. Unlike HMC's kick-gradient quirk (which
only perturbs the proposal, leaving the chain exact), this one makes the MH
ratio inconsistent with the actual proposal density, so the bounded
reference mode has a measurable stationary bias (truncated N(1,1) at 0:
mean 1.40 vs true 1.288). ``bounded_grad="exact"`` is the corrected mode
(measured 1.286) and the right choice unless bit-for-bit reference
behavior is the goal; see docs/box_constraints.md and
tests/test_bounded_samplers.py::test_mala_truncated_normal_exactness.

Unlike the reference (3 kernel+gradient evaluations per draw), the gradient
at the current point is carried in the chain state, so each draw costs one
fresh ``value_and_grad`` of the target — the minimum possible.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_tpu import adaptation
from mcmc_tpu import bounds as bounds_mod
from mcmc_tpu import stats
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import MALASettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["mala", "MALAState", "build_mala_kernel"]


class MALAState(NamedTuple):
    position: jax.Array
    log_prob: jax.Array
    grad: jax.Array      # raw target gradient at position (constrained-space
                         # user gradient in reference mode, box gradient else)
    jac: jax.Array       # inv-Jacobian diagonal at position (ones when unused)
    da: adaptation.DualAveraging
    wv: adaptation.WindowedVariance   # preconditioner adaptation (diag)
    pM: jax.Array        # dense learned preconditioner ((1,) in diag mode)
    pchol: jax.Array     # its Cholesky ((1,) in diag mode)
    pm2: jax.Array       # dense outer-product accumulator ((1,) diag mode)
    draw_ind: jax.Array


def _log_mvn_general(x, mu, sigma):
    """MVN log-density on a general (possibly asymmetric) matrix via an
    explicit solve + slogdet. The bounded dense-preconditioner path builds
    ``eps^2 * J * M``, which is *not* symmetric; the reference evaluates
    dmvnorm on it directly with QUAD_FORM_INV + LOG_DET (mala.ipp:54-57,
    dmvnorm.hpp:28-54), so a Cholesky — which silently reads only the lower
    triangle — would diverge from the reference. Quirk reproduced."""
    cent = x - mu
    k = x.shape[-1]
    quad = cent @ jnp.linalg.solve(sigma, cent)
    _sign, logdet = jnp.linalg.slogdet(sigma)
    return -0.5 * k * stats.LOG_2PI - 0.5 * (logdet + quad)


def build_mala_kernel(prob: common.Problem, precond: common.SPD, step_size,
                      bounded_grad="reference", adapt_cfg=None,
                      precond_cfg=None):
    reference_mode = prob.vals_bound and bounded_grad == "reference"
    adapt_m = precond_cfg is not None
    dense = adapt_m and precond_cfg.get("mode") == "dense"

    if reference_mode:
        user_vg = jax.value_and_grad(prob.log_kernel)

        def eval_point(z):
            """Returns (box_log_prob, raw gradient, jac) at z."""
            x = bounds_mod.inv_transform(z, prob.codes, prob.lower_bounds, prob.upper_bounds)
            val, grad_x = user_vg(x)
            lp = val + bounds_mod.log_jacobian(z, prob.codes, prob.lower_bounds, prob.upper_bounds)
            jac = bounds_mod.inv_jacobian_diag(z, prob.codes, prob.lower_bounds, prob.upper_bounds)
            return lp, grad_x, jac
    else:
        box_vg = jax.value_and_grad(prob.box_log_kernel)

        def eval_point(z):
            val, grad_z = box_vg(z)
            return val, grad_z, jnp.ones_like(z)

    def kick_of(grad, jac, pvar, pM):
        """Drift direction J * (M @ grad); M is the fixed preconditioner or
        the adapted diagonal/dense covariance."""
        if dense:
            mg = pM @ grad
        elif adapt_m:
            mg = pvar * grad
        else:
            mg = precond.mv(grad)
        return jac * mg if reference_mode else mg

    def mean_of(z, kick, eps2):
        return z + 0.5 * eps2 * kick

    def prop_sigma(jac, eps2, pvar, pM):
        """Proposal covariance eps^2 * J * M in the cheapest representation.
        (The dense mode never calls this — its asymmetry term is computed
        from the carried Cholesky directly.)"""
        if adapt_m:
            return eps2 * jac * pvar
        if precond.kind == "identity":
            return eps2 * jac
        if precond.kind == "diag":
            return eps2 * jac * precond.mat
        return eps2 * jac[:, None] * precond.mat

    def init(position):
        lp, grad, jac = eval_point(position)
        dim = position.shape[0]
        dt = position.dtype
        return MALAState(
            position=position, log_prob=lp, grad=grad, jac=jac,
            da=adaptation.da_init(jnp.asarray(step_size, dt)),
            wv=adaptation.wv_init(dim, dt),
            pM=jnp.eye(dim, dtype=dt) if dense else jnp.ones((1,), dt),
            pchol=jnp.eye(dim, dtype=dt) if dense else jnp.ones((1,), dt),
            pm2=jnp.zeros((dim, dim), dt) if dense else jnp.ones((1,), dt),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    def step(key, state: MALAState):
        k_noise, k_accept = jax.random.split(key)
        if adapt_cfg is None:
            eps = step_size
        else:
            adapting = state.draw_ind < adapt_cfg["n_burnin"]
            eps = jnp.exp(jnp.where(adapting, state.da.log_eps,
                                    state.da.log_eps_bar))
        eps2 = eps * eps
        pvar = state.wv.var
        noise = jax.random.normal(k_noise, state.position.shape, state.position.dtype)

        prev_mean = mean_of(state.position,
                            kick_of(state.grad, state.jac, pvar, state.pM),
                            eps2)
        if dense:
            scaled = state.pchol @ noise
        elif adapt_m:
            scaled = jnp.sqrt(pvar) * noise
        else:
            scaled = precond.sqrt_mv(noise)
        if reference_mode:
            scaled = jnp.sqrt(state.jac) * scaled
        proposal = prev_mean + eps * scaled

        prop_lp, prop_grad, prop_jac = eval_point(proposal)
        prop_lp = jnp.where(jnp.isfinite(prop_lp), prop_lp, -jnp.inf)
        prop_mean = mean_of(proposal,
                            kick_of(prop_grad, prop_jac, pvar, state.pM),
                            eps2)

        # mala_prop_adjustment (reference mala.ipp:30-70): both covariance
        # terms use the proposal's Jacobian, as in the reference.
        if dense:
            # sigma = eps^2 * pM is symmetric PD (dense adapt is
            # unbounded-only, enforced at the entry point) and its
            # Cholesky eps * pchol is already carried in the state; the
            # log-det terms of the two MVN densities cancel, so the
            # asymmetry term reduces to two O(d^2) triangular solves
            # instead of two fresh O(d^3) factorizations inside dmvnorm
            # (identical value).
            r_back = jax.scipy.linalg.solve_triangular(
                state.pchol, state.position - prop_mean, lower=True) / eps
            r_fwd = jax.scipy.linalg.solve_triangular(
                state.pchol, proposal - prev_mean, lower=True) / eps
            adj = 0.5 * (r_fwd @ r_fwd - r_back @ r_back)
        elif reference_mode and precond.kind == "full" and not adapt_m:
            # eps^2 * J * M is asymmetric; evaluate it the reference's way
            sigma = prop_sigma(prop_jac, eps2, pvar, state.pM)
            adj = _log_mvn_general(state.position, prop_mean, sigma) \
                - _log_mvn_general(proposal, prev_mean, sigma)
        else:
            sigma = prop_sigma(prop_jac, eps2, pvar, state.pM)
            adj = stats.dmvnorm(state.position, prop_mean, sigma, log=True) \
                - stats.dmvnorm(proposal, prev_mean, sigma, log=True)

        comp = jnp.minimum(0.01, prop_lp - state.log_prob + adj)
        u = jax.random.uniform(k_accept, dtype=state.position.dtype)
        accepted = u < jnp.exp(comp)

        new_position = jnp.where(accepted, proposal, state.position)

        da = state.da
        if adapt_cfg is not None:
            accept_stat = jnp.minimum(1.0, jnp.exp(comp))
            accept_stat = jnp.where(jnp.isnan(accept_stat), 0.0, accept_stat)
            da_new = adaptation.da_update(da, accept_stat, adapt_cfg["target"])
            da = jax.tree_util.tree_map(
                lambda new, old: jnp.where(adapting, new, old), da_new, da)

        wv = state.wv
        pM, pchol, pm2 = state.pM, state.pchol, state.pm2
        if adapt_m and not dense:
            wv, da = adaptation.windowed_precond_step(
                wv, da, new_position, state.draw_ind, precond_cfg,
                reset_da=adapt_cfg is not None)
        elif dense:
            wv, da, pM, pchol, pm2 = adaptation.windowed_dense_step(
                state.wv, da, pM, pchol, pm2,
                new_position, state.draw_ind, precond_cfg,
                reset_da=adapt_cfg is not None)

        new_state = MALAState(
            position=new_position,
            log_prob=jnp.where(accepted, prop_lp, state.log_prob),
            grad=jnp.where(accepted, prop_grad, state.grad),
            jac=jnp.where(accepted, prop_jac, state.jac),
            da=da,
            wv=wv,
            pM=pM,
            pchol=pchol,
            pm2=pm2,
            draw_ind=state.draw_ind + 1,
        )
        return new_state, {"accepted": accepted}

    return init, step


def mala(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None, mesh=None, checkpoint_dir=None, checkpoint_every=500,
         dtype=None, bounded_grad="reference", adapt_step_size=False,
         adapt_precond=False, pooled_adaptation=False,
         target_accept=None, thin=1, return_resume=False) -> SamplerResult:
    """``adapt_step_size=True`` tunes the step size toward 0.574 acceptance
    during burn-in; ``adapt_precond=True`` learns a diagonal preconditioner
    (drift **and** proposal covariance) from windowed Welford variance
    estimates — the Stan-style schedule NUTS mass adaptation uses — pooled
    across chains with ``pooled_adaptation``. Incompatible with a user
    ``precond_mat``. (No reference analog; MCMCLib's ``precond_mat`` is a
    fixed user matrix, mcmc_structs.hpp:130.) ``return_resume=True``
    attaches ``diagnostics["resume"](key, n_keep)`` — a warm continuation
    from the final kernel state; incompatible with ``checkpoint_dir``."""
    algo, s = resolve_settings(settings, "mala_settings", MALASettings)
    key = resolve_key(key, algo)
    if bounded_grad not in ("reference", "exact"):
        raise ValueError(f"bounded_grad must be 'reference' or 'exact', "
                         f"got {bounded_grad!r}")
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains, dtype)
    precond = common.make_spd(s.precond_mat, prob.n_vals, prob.dtype)
    if adapt_precond and s.precond_mat is not None:
        raise ValueError("adapt_precond is incompatible with a user "
                         "precond_mat — the preconditioner is learned")

    adapt_cfg = None
    if adapt_step_size:
        adapt_cfg = {
            "n_burnin": s.n_burnin_draws,
            "target": target_accept or adaptation.TARGET_ACCEPT["mala"],
        }
    precond_cfg = None
    if adapt_precond:
        mode = {True: "diag"}.get(adapt_precond, adapt_precond)
        if mode not in ("diag", "dense"):
            raise ValueError(f"adapt_precond must be False/True/'diag'/"
                             f"'dense', got {adapt_precond!r}")
        if mode == "dense" and algo.vals_bound:
            raise ValueError("adapt_precond='dense' is unbounded-only "
                             "(the bounded dense proposal matrix is "
                             "asymmetric; use 'diag' with bounds)")
        precond_cfg = adaptation.make_precond_cfg(
            s.n_burnin_draws, pooled_adaptation, common.CHAIN_AXIS_NAME)
        precond_cfg["mode"] = mode
    init, step = build_mala_kernel(prob, precond, s.step_size, bounded_grad,
                                   adapt_cfg, precond_cfg)
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
            diagnostics["precond_var"] = final_state.wv.var \
                if precond_cfg["mode"] == "diag" else final_state.pM
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
