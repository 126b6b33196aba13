"""The full Bayesian workflow in one script (no reference analog — MCMCLib
stops at the draw matrix): fit with convergence gates, posterior summary,
posterior-predictive check, model comparison by PSIS-LOO, and
simulation-based calibration of the sampler itself.

Model: y_i ~ N(beta . x_i, sigma^2) linear regression with a misspecified
alternative (drop a covariate) to give the comparison something to rank.
"""

from _common import setup

jax = setup()
import jax.numpy as jnp
import numpy as np

import mcmc_tpu
from mcmc_tpu import diagnostics

# ---- data -----------------------------------------------------------------
key = jax.random.PRNGKey(0)
n, p = 200, 3
X = jax.random.normal(key, (n, p))
beta_true = jnp.array([1.5, -2.0, 0.7])
sigma_true = 0.5
y = X @ beta_true + sigma_true * jax.random.normal(jax.random.PRNGKey(1), (n,))


def make_model(Xd):
    def log_kernel(params):     # params = (beta..., log_sigma)
        beta, log_s = params[:-1], params[-1]
        s2 = jnp.exp(2.0 * log_s)
        resid = y - Xd @ beta
        return (-0.5 * jnp.sum(resid**2) / s2 - n * log_s
                - 0.5 * jnp.sum(beta**2) / 10.0 - 0.5 * log_s**2 / 4.0)
    return log_kernel


# ---- 1. fit with convergence gates -----------------------------------------
fit = mcmc_tpu.fit(jnp.zeros(p + 1), make_model(X), n_chains=8,
                   n_warmup=800, n_draws=1000, key=jax.random.PRNGKey(2),
                   rhat_target=1.01, min_ess=400)
summ = fit.diagnostics["summary"]
print("converged:", fit.diagnostics["converged"],
      "in", fit.diagnostics["n_rounds"], "round(s)")
print("beta posterior means:", np.asarray(summ["mean"][:p]).round(3),
      "(truth", np.asarray(beta_true).round(3), ")")

# ---- 2. posterior predictive check ------------------------------------------
pp = mcmc_tpu.posterior_predictive(
    fit, lambda k, par: X @ par[:-1]
    + jnp.exp(par[-1]) * jax.random.normal(k, (n,)),
    key=jax.random.PRNGKey(3))
y_rep = np.asarray(pp).reshape(-1, n)
stat_obs = float(np.std(np.asarray(y)))
stat_rep = y_rep.std(axis=1)
ppp = float((stat_rep > stat_obs).mean())
print("posterior predictive p-value for sd(y):", round(ppp, 3),
      "(calibrated ~ 0.5)")

# ---- 3. model comparison: full model vs one dropped covariate ---------------
def loglik_fn(Xd):
    return lambda par: (-0.5 * (y - Xd @ par[:-1])**2
                        / jnp.exp(2.0 * par[-1])
                        - par[-1] - 0.5 * jnp.log(2.0 * jnp.pi))

fit_red = mcmc_tpu.fit(jnp.zeros(p), make_model(X[:, :2]), n_chains=8,
                       n_warmup=800, n_draws=1000,
                       key=jax.random.PRNGKey(4))
loo_full = mcmc_tpu.psis_loo(
    mcmc_tpu.pointwise_log_lik(fit.draws, loglik_fn(X)))
loo_red = mcmc_tpu.psis_loo(
    mcmc_tpu.pointwise_log_lik(fit_red.draws, loglik_fn(X[:, :2])))
rank = mcmc_tpu.compare({"full": loo_full, "reduced": loo_red})
print("PSIS-LOO ranking:", [(r["name"], round(float(r["elpd_diff"]), 1))
                            for r in rank])

# ---- 4. calibrate the sampler itself (SBC) ----------------------------------
prior = lambda k: jnp.concatenate([
    jnp.sqrt(10.0) * jax.random.normal(k, (p,)),
    2.0 * jax.random.normal(jax.random.fold_in(k, 1), (1,))])
sim = lambda k, th: X @ th[:p] + jnp.exp(th[p]) \
    * jax.random.normal(k, (n,))


def post(k, data):
    def lk(params):
        beta, log_s = params[:-1], params[-1]
        s2 = jnp.exp(2.0 * log_s)
        resid = data - X @ beta
        return (-0.5 * jnp.sum(resid**2) / s2 - n * log_s
                - 0.5 * jnp.sum(beta**2) / 10.0 - 0.5 * log_s**2 / 4.0)
    return mcmc_tpu.fit(jnp.zeros(p + 1), lk, n_chains=4, n_warmup=400,
                        n_draws=256, key=k).draws

# 16 sims: each sim is a full sequential fit() with its own dispatches,
# so this phase is latency-dominated — 16 keeps the uniformity
# check meaningful (chi-squared over 8 bins) at ~40% of the wall clock;
# raise n_sims for a publication-grade calibration
r = mcmc_tpu.sbc(jax.random.PRNGKey(5), prior, sim, post,
                 n_sims=16, n_rank_draws=31, thin=8, n_bins=8)
print("SBC uniformity p-values per dim:",
      np.asarray(r["p_value"]).round(3), "(all should be >> 0.01)")
