"""AEES on a bimodal Gaussian mixture — reference examples/eigen/
aees_mixture.cpp: ladder (60, 9) + T=1, 11 energy rings, ee_prob 0.05;
prints sign-filtered mode means as the reference does."""

from _common import setup

jax = setup()
import jax.numpy as jnp
import numpy as np

import mcmc_tpu
from mcmc_tpu import models

mu = jnp.array([[-2.0, -2.0], [2.0, 2.0]])
log_kernel = models.gaussian_mixture_model(
    mu, sig_sq=jnp.array([0.1, 0.1]), weights=jnp.array([0.5, 0.5])
)

settings = mcmc_tpu.AlgoSettings(rng_seed_value=2)
settings.aees_settings.n_initial_draws = 1000
settings.aees_settings.n_burnin_draws = 1000
settings.aees_settings.n_keep_draws = 20000
settings.aees_settings.n_rings = 11
settings.aees_settings.ee_prob_par = 0.05
settings.aees_settings.temper_vec = jnp.array([60.0, 9.0])
settings.aees_settings.par_scale = 1.0
settings.aees_settings.cov_mat = 0.35 * jnp.eye(2)

out = mcmc_tpu.aees(mu[0], log_kernel, settings)
d = np.asarray(out.draws)
print("posterior mean for > 0.1:", d[d[:, 0] > 0.1].mean(axis=0))
print("posterior mean for < -0.1:", d[d[:, 0] < -0.1].mean(axis=0))

# Beyond the reference: let the sampler BUILD the ladder. A pilot measures
# the log-kernel spread across inverse temperatures and places rungs at
# dbeta = spacing/sigma_val(beta) — the overlap the equi-energy jump
# acceptance depends on — so only the hottest temperature needs choosing
# (benchmarks/aees_ladder_sweep.py compares the ladders).
settings.aees_settings.temper_vec = jnp.array([60.0])
out2 = mcmc_tpu.aees(mu[0], log_kernel, settings, adapt_ladder=True,
                     key=jax.random.PRNGKey(3))
print("auto ladder:", np.asarray(out2.diagnostics["temperatures"]).round(2))
print("per-rung EE accept:",
      np.asarray(out2.diagnostics["ee_accept_rate"]).round(3))
