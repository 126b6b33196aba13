"""ChEES-HMC on Bayesian logistic regression — the accelerator-native alternative
to NUTS (no reference analog; Hoffman, Radul & Sountsov 2021).

Run many chains: the trajectory-length criterion pools expectations across
the chain batch, so more chains = better adaptation AND more throughput."""

from _common import setup

jax = setup()
import jax.numpy as jnp
import numpy as np

import mcmc_tpu
from mcmc_tpu import models, diagnostics

X, y, beta_true = models.make_logistic_regression_data(
    jax.random.PRNGKey(0), 500, 25)
log_kernel = models.logistic_regression_model(X, y)

out = mcmc_tpu.chees(
    jnp.zeros(25), log_kernel,
    mcmc_tpu.ChEESSettings(n_burnin_draws=500, n_keep_draws=1000),
    n_chains=128, key=jax.random.PRNGKey(1), adapt_mass_matrix=True,
)

d = np.asarray(out.draws)
print("posterior mean vs truth (first 5):")
print("  est :", d.reshape(-1, 25).mean(axis=0)[:5].round(2))
print("  true:", np.asarray(beta_true)[:5].round(2))
print("adapted trajectory length:",
      float(out.diagnostics["adapted_trajectory_length"][0]))
print("mean leapfrogs/draw:", float(np.asarray(out.diagnostics["n_leap"]).mean()))
print("max split R-hat:", float(np.asarray(diagnostics.split_rhat(out.draws)).max()))
