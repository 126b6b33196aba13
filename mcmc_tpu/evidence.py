"""Marginal-likelihood (model evidence) estimation.

No reference analog — MCMCLib samples posteriors but cannot produce
``log Z = log ∫ prior(x) · lik(x) dx``, the quantity behind Bayes factors
and posterior model probabilities. This module adds the two classical
gold-standard estimators, built on the framework's own replica-exchange
machinery, plus a curvature shortcut:

- **Power-posterior path sampling** (:func:`thermo_evidence`): a ladder of
  K rungs targets ``pi_beta(x) ∝ prior(x) · lik(x)^beta`` for an ascending
  schedule ``beta_k = (k/(K-1))^c`` (Friel & Pettitt 2008 recommend c ≈ 5,
  clustering rungs near the prior where E[log lik] moves fastest). From the
  per-rung expectations of ``log lik`` it reports

  * *thermodynamic integration* (TI): the trapezoid quadrature of
    ``dlog Z/dbeta = E_beta[log lik]`` over [0, 1], with the second-order
    variance correction of Friel, Hurn & Wyse (2014) —
    ``− Σ Δβ²/12 · (V_{k+1} − V_k)`` — that cancels the leading
    discretization bias;
  * *stepping-stone* (SS, Xie et al. 2011): the telescoped ratio
    ``log Z = Σ_k log E_{beta_k}[lik^{Δβ_k}]``, each factor estimated by a
    log-mean-exp over rung k's draws — unbiased in the ratio sense and the
    recommended headline (TI's quadrature bias is one-signed; SS is not).

  Accelerator-native design mirrors :mod:`mcmc_tpu.samplers.pt`: the whole ladder is
  one ``(K, d)`` batch (K tempered HMC/RWMH moves run as a single vmapped
  leapfrog), replica swaps are deterministic even/odd masked permutations
  (the non-reversible DEO scheme — zero host sync, zero kernel re-evals
  because each replica carries its ``log lik``/``log prior`` values), and
  ``n_chains`` independent ladders vmap/shard over the chain axis — the
  cross-chain spread of per-chain estimates IS the reported Monte-Carlo
  standard error, no autocorrelation estimate needed. Per-rung step sizes
  dual-average toward standard acceptance targets during burn-in, pooled
  across chains (``lax.pmean`` — a psum when ``mesh``-sharded), because the
  beta=0 rung sees the prior's scale and the beta=1 rung the posterior's.

- **Laplace evidence** (:attr:`mcmc_tpu.laplace.LaplaceResult.log_evidence`):
  ``log Z ≈ log p(mode) + d/2·log 2π + ½·log|Σ|`` — exact for Gaussian
  posteriors, a cheap sanity anchor otherwise.

The third estimator in the framework is adaptive-tempered SMC
(:func:`mcmc_tpu.samplers.smc.smc`), whose ``diagnostics["log_z"]`` estimates
the same constant from particle weights; :func:`thermo_evidence` and SMC
cross-validate each other (see tests/test_evidence.py).

Requirements: ``log_prior`` must be a *normalized* log density (an improper
prior makes log Z meaningless) and the beta=0 rung samples it by MCMC, so it
must be proper. For bounded problems the transform's log-Jacobian belongs to
the prior factor (untempered) — the rung-0 chain then samples exactly the
prior pushed to unconstrained space.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import adaptation, bounds as bounds_mod, integrators
from mcmc_tpu.settings import EvidenceSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["thermo_evidence", "EvidenceResult", "power_schedule"]


def power_schedule(n_temps: int, power: float, dtype):
    """Ascending inverse-temperature schedule ``beta_k = (k/(K-1))^power``,
    ``beta_0 = 0`` (prior) .. ``beta_{K-1} = 1`` (posterior)."""
    K = int(n_temps)
    if K < 2:
        raise ValueError(f"n_temps must be >= 2, got {K}")
    frac = jnp.arange(K, dtype=dtype) / (K - 1)
    return frac ** jnp.asarray(power, dtype)


@dataclasses.dataclass
class EvidenceResult:
    """Power-posterior evidence estimates.

    ``log_z`` (the headline) is the stepping-stone estimate averaged over
    the independent ladders; ``log_z_se`` its cross-chain standard error.
    ``log_z_ti`` is the variance-corrected thermodynamic-integration
    estimate on the same draws (agreement between the two is the standard
    internal consistency check). ``expected_log_lik``/``var_log_lik`` give
    the per-rung curve ``E_beta[log lik]`` — plotting it against ``betas``
    shows whether the schedule resolves the steep near-prior region.
    """

    log_z: Any
    log_z_se: Any
    log_z_ti: Any
    log_z_ti_se: Any
    log_z_per_chain: Any      # (n_chains,) stepping-stone per ladder
    log_z_ti_per_chain: Any   # (n_chains,) corrected TI per ladder
    betas: Any                # (K,) schedule
    expected_log_lik: Any     # (K,) chain-pooled per-rung mean log lik
    var_log_lik: Any          # (K,) chain-pooled per-rung variance
    accept_rate: Any          # (K,) per-rung inner-move acceptance
    swap_accept_rate: Any     # (K-1,) adjacent-rung swap acceptance
    step_sizes: Any           # (K,) adapted per-rung step sizes / scales
    n_chains: int = 1


class _EvState(NamedTuple):
    X: jax.Array        # (K, d) replica positions, prior rung first
    ll: jax.Array       # (K,) log-likelihood values
    lp: jax.Array       # (K,) box log-prior values (incl. log-Jacobian)
    da: Any             # DualAveraging over (K,) per-rung log step sizes
    draw_ind: jax.Array


def _build_kernel(box_prior, box_lik, s: EvidenceSettings, dim, dt,
                  n_adapt, axis_name=None):
    """Power-posterior replica-exchange transition kernel.

    Structure mirrors :func:`mcmc_tpu.samplers.pt.build_pt_kernel` (DEO
    even/odd swaps as masked permutations), but the target is
    ``lp(z) + beta·ll(z)`` with the prior factor untempered, and each rung
    owns a dual-averaged step size."""
    betas = power_schedule(s.n_temps, s.schedule_power, dt)
    K = int(betas.shape[0])
    inner = s.inner
    if inner not in ("hmc", "rwmh"):
        raise ValueError(f"inner must be 'hmc' or 'rwmh', got {inner!r}")
    target_acc = (s.target_accept if s.target_accept is not None
                  else (0.65 if inner == "hmc" else 0.234))
    swap_every = max(int(s.swap_every), 1)
    pair_idx = jnp.arange(K - 1)
    idx_K = jnp.arange(K)

    def tempered_grad(z, beta):
        # separate AD passes so the beta = 0 (prior) rung is driven by the
        # prior gradient ALONE: beta * grad_ll with a NaN/inf likelihood
        # gradient (hard-constraint likelihoods) must not poison the drift
        g_lp = jax.grad(box_prior)(z)
        g_ll = jax.grad(box_lik)(z)
        g_ll = jnp.where(jnp.isfinite(g_ll), g_ll, 0.0)
        return g_lp + beta * g_ll

    def eval_parts(z):
        lp = box_prior(z)
        ll = box_lik(z)
        return (jnp.where(jnp.isfinite(lp), lp, -jnp.inf),
                jnp.where(jnp.isfinite(ll), ll, -jnp.inf))

    def bll(ll, beta):
        """beta * ll with the beta = 0 rung exact: 0 * (-inf) would be NaN
        and would silently restrict the prior rung to {lik > 0}."""
        return jnp.where(beta > 0, beta * ll, 0.0)

    def inner_hmc(key, x, ll, lp, beta, eps):
        k_mom, k_acc = jax.random.split(key)
        p0 = jax.random.normal(k_mom, (dim,), dt)
        z, p = integrators.leapfrog(
            lambda zz: tempered_grad(zz, beta), lambda m: m, eps,
            int(s.n_leap_steps), x, p0)
        lp_new, ll_new = eval_parts(z)
        dH = (lp_new + bll(ll_new, beta)) - (lp + bll(ll, beta)) \
            - 0.5 * (p @ p - p0 @ p0)
        dH = jnp.where(jnp.isnan(dH), -jnp.inf, dH)
        alpha = jnp.exp(jnp.minimum(0.0, dH))
        acc = jnp.log(jax.random.uniform(k_acc, dtype=dt)) \
            < jnp.minimum(0.0, dH)
        return (jnp.where(acc, z, x), jnp.where(acc, ll_new, ll),
                jnp.where(acc, lp_new, lp), acc, alpha)

    def inner_rwmh(key, x, ll, lp, beta, scale):
        k_n, k_u = jax.random.split(key)
        prop = x + scale * jax.random.normal(k_n, (dim,), dt)
        lp_new, ll_new = eval_parts(prop)
        comp = (lp_new + bll(ll_new, beta)) - (lp + bll(ll, beta))
        comp = jnp.where(jnp.isnan(comp), -jnp.inf, comp)
        alpha = jnp.exp(jnp.minimum(0.0, comp))
        acc = jnp.log(jax.random.uniform(k_u, dtype=dt)) \
            < jnp.minimum(0.0, comp)
        return (jnp.where(acc, prop, x), jnp.where(acc, ll_new, ll),
                jnp.where(acc, lp_new, lp), acc, alpha)

    inner_step = inner_hmc if inner == "hmc" else inner_rwmh

    def step(key, state: _EvState):
        draw_ind = state.draw_ind
        eps = jnp.exp(jnp.where(draw_ind < n_adapt,
                                state.da.log_eps, state.da.log_eps_bar))

        k_inner, k_swap = jax.random.split(key)
        inner_keys = jax.random.split(k_inner, K)
        X, ll, lp, acc, alpha = jax.vmap(inner_step)(
            inner_keys, state.X, state.ll, state.lp, betas, eps)

        # per-rung dual averaging toward target_acc, pooled across ladders
        pooled = alpha
        if axis_name is not None:
            pooled = lax.pmean(pooled, axis_name)
        da_new = adaptation.da_update(state.da, pooled, target_acc)
        da = jax.tree_util.tree_map(
            lambda new, old: jnp.where(draw_ind < n_adapt, new, old),
            da_new, state.da)

        # DEO swap round: deterministic even/odd alternation (non-reversible)
        swap_round = draw_ind // swap_every
        do_round = (draw_ind % swap_every) == (swap_every - 1)
        parity = (swap_round % 2).astype(pair_idx.dtype)
        active = do_round & ((pair_idx % 2) == parity)

        # pi_{beta_k}(x_{k+1}) pi_{beta_{k+1}}(x_k) / (pi_{beta_k}(x_k)
        # pi_{beta_{k+1}}(x_{k+1})): the untempered prior factors cancel
        log_alpha = (betas[1:] - betas[:-1]) * (ll[:-1] - ll[1:])
        # two adjacent -inf likelihoods give (-inf) - (-inf) = NaN: the
        # states are exchangeable, reject deterministically instead
        log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
        u = jax.random.uniform(k_swap, (K - 1,), dt)
        acc_swap = active & (jnp.log(u) < jnp.minimum(0.0, log_alpha))

        with_next = jnp.concatenate([acc_swap, jnp.zeros((1,), bool)])
        with_prev = jnp.concatenate([jnp.zeros((1,), bool), acc_swap])
        perm = jnp.where(with_next, idx_K + 1,
                         jnp.where(with_prev, idx_K - 1, idx_K))
        X, ll, lp = X[perm], ll[perm], lp[perm]

        info = {
            "accepted": acc[K - 1],
            "acc_all": acc.astype(dt),
            "swap_accepted": acc_swap.astype(dt),
            "swap_attempted": active.astype(dt),
        }
        return _EvState(X=X, ll=ll, lp=lp, da=da,
                        draw_ind=draw_ind + 1), info

    def make_state0(first):
        lp0, ll0 = eval_parts(first)
        eps0 = jnp.full((K,), jnp.asarray(
            s.step_size if inner == "hmc" else s.par_scale, dt))
        return _EvState(
            X=jnp.tile(first[None, :], (K, 1)),
            ll=jnp.full((K,), ll0, dt),
            lp=jnp.full((K,), lp0, dt),
            da=adaptation.da_init(eps0),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    return betas, make_state0, step


def _logmeanexp(a, axis):
    n = a.shape[axis]
    return jax.scipy.special.logsumexp(a, axis=axis) - jnp.log(
        jnp.asarray(n, a.dtype))


def _cond_mean_var(ll, axis):
    """Mean/variance over ``axis`` conditional on finite entries — the
    beta -> 0+ limit of the per-rung expectation when the likelihood has
    hard constraints (ll = -inf on prior mass). Empty slices report
    (-inf, 0)."""
    fin = jnp.isfinite(ll)
    cnt = fin.sum(axis=axis)
    safe = jnp.where(fin, ll, 0.0)
    mean = jnp.where(cnt > 0, safe.sum(axis=axis) / jnp.maximum(cnt, 1),
                     -jnp.inf)
    mean_safe = jnp.expand_dims(jnp.where(jnp.isfinite(mean), mean, 0.0),
                                axis)
    dev2 = jnp.where(fin, (safe - mean_safe) ** 2, 0.0)
    var = jnp.where(cnt > 1, dev2.sum(axis=axis) / jnp.maximum(cnt - 1, 1),
                    0.0)
    return mean, var


def estimate_from_ll(ll_draws, betas):
    """Estimators from a ``(n_keep, n_chains, K)`` log-likelihood trace.

    Returns ``(log_z_ss, log_z_ti, e_ll, v_ll)`` with the per-chain
    stepping-stone and variance-corrected-TI estimates ``(n_chains,)`` and
    the chain-pooled per-rung mean/variance curves ``(K,)``.

    Hard-constraint caveat: per-rung means/variances condition on finite
    ``ll`` (the beta -> 0+ limit), so the curves stay finite when the
    likelihood is -inf on part of the prior — but then the TI path has a
    discontinuity at beta = 0 (``Z(0+) = P(lik > 0) != 1``) that NO
    quadrature can see, so ``log_z_ti`` estimates
    ``log Z - log P(lik > 0)`` and is biased HIGH by the prior's
    infeasible mass. The stepping-stone ``log_z`` handles the atom
    exactly (its rung-0 log-mean-exp includes the zero-likelihood draws)
    and is the headline for constrained likelihoods."""
    dbeta = betas[1:] - betas[:-1]                      # (K-1,)

    # stepping stone: rung k's draws bridge beta_k -> beta_{k+1}
    ratios = _logmeanexp(
        dbeta[None, None, :] * ll_draws[:, :, :-1], axis=0)  # (C, K-1)
    log_z_ss = ratios.sum(axis=-1)                           # (C,)

    e, v = _cond_mean_var(ll_draws, axis=0)                  # (C, K)
    trap = 0.5 * (dbeta[None, :] * (e[:, 1:] + e[:, :-1])).sum(axis=-1)
    corr = (dbeta[None, :] ** 2 / 12.0 * (v[:, 1:] - v[:, :-1])).sum(axis=-1)
    log_z_ti = trap - corr                                   # (C,)

    flat = ll_draws.reshape(-1, ll_draws.shape[-1])
    e_all, v_all = _cond_mean_var(flat, axis=0)
    return log_z_ss, log_z_ti, e_all, v_all


def thermo_evidence(initial_vals, log_prior, log_lik, settings=None, *,
                    n_chains=None, key=None, mesh=None,
                    dtype=None) -> EvidenceResult:
    """Estimate ``log Z = log ∫ prior(x)·exp(log_lik(x)) dx`` by
    power-posterior path sampling (module docstring).

    ``log_prior`` must be a normalized log density; ``log_lik`` the
    log-likelihood. Both are pure JAX functions of the parameter vector.
    ``n_chains`` independent replica ladders run vmapped (sharded over
    ``mesh``); the headline standard errors are cross-chain, so use at
    least ~8 chains for trustworthy error bars. Bounds come from
    ``settings``'s umbrella fields, exactly as in the samplers; the
    log-Jacobian attaches to the (untempered) prior factor.
    """
    algo, s = resolve_settings(settings, "evidence_settings", EvidenceSettings)
    key = resolve_key(key, algo)
    from mcmc_tpu.pytree import coerce_model
    initial_vals, (log_prior, log_lik), _unravel = coerce_model(
        initial_vals, log_prior, log_lik)

    # setup_problem wires bounds/transform for the PRIOR factor (the box
    # log-prior includes the log-Jacobian); the likelihood factor is the
    # plain user function composed with inv_transform, no Jacobian.
    prob = common.setup_problem(initial_vals, log_prior, algo, n_chains, dtype)
    dim, dt = prob.n_vals, prob.dtype
    box_prior = prob.box_log_kernel
    if prob.vals_bound:
        codes, lb, ub = prob.codes, prob.lower_bounds, prob.upper_bounds
        box_lik = lambda z: log_lik(bounds_mod.inv_transform(z, codes, lb, ub))
    else:
        box_lik = log_lik

    n_adapt = s.n_adapt_draws if s.n_adapt_draws is not None \
        else s.n_burnin_draws
    betas, make_state0, step = _build_kernel(
        box_prior, box_lik, s, dim, dt, int(n_adapt),
        axis_name=common.CHAIN_AXIS_NAME)
    K = int(betas.shape[0])

    state0 = jax.vmap(make_state0)(prob.first_draw)
    final, ll_draws, infos = common.run_sampler_loop(
        key, state0, step, s.n_burnin_draws, s.n_keep_draws,
        collect_fn=lambda st: st.ll, mesh=mesh)
    # ll_draws: (n_keep, n_chains, K)

    log_z_ss, log_z_ti, e_ll, v_ll = estimate_from_ll(ll_draws, betas)

    C = int(log_z_ss.shape[0])
    se_ss = jnp.std(log_z_ss, ddof=1) / jnp.sqrt(jnp.asarray(C, dt)) \
        if C > 1 else jnp.asarray(jnp.nan, dt)
    se_ti = jnp.std(log_z_ti, ddof=1) / jnp.sqrt(jnp.asarray(C, dt)) \
        if C > 1 else jnp.asarray(jnp.nan, dt)

    acc_rate = infos["acc_all"].mean(axis=(0, 1))            # (K,)
    att = jnp.maximum(infos["swap_attempted"].sum(axis=(0, 1)), 1.0)
    swap_rate = infos["swap_accepted"].sum(axis=(0, 1)) / att

    eps_final = jnp.exp(final.da.log_eps_bar[0])             # chain-pooled

    return EvidenceResult(
        log_z=log_z_ss.mean(), log_z_se=se_ss,
        log_z_ti=log_z_ti.mean(), log_z_ti_se=se_ti,
        log_z_per_chain=log_z_ss, log_z_ti_per_chain=log_z_ti,
        betas=betas, expected_log_lik=e_ll, var_log_lik=v_ll,
        accept_rate=acc_rate, swap_accept_rate=swap_rate,
        step_sizes=eps_final, n_chains=C,
    )
