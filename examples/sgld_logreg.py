"""Stochastic-gradient Langevin dynamics on a tall logistic regression:
minibatch gradients, thousands of draws per second, no full-data pass per
draw — the tall-data companion to examples/data_parallel_hmc.py.

No counterpart in the reference: all of MCMCLib's samplers consume a
full-data log-kernel callback each draw.
"""

from _common import setup

jax = setup()
import jax.numpy as jnp

import mcmc_tpu

N, D = 65536, 16
k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
X = jax.random.normal(k1, (N, D))
beta_true = 0.5 * jax.random.normal(k2, (D,))
y = (jax.random.uniform(k3, (N,)) < jax.nn.sigmoid(X @ beta_true)).astype(jnp.float32)

log_prior = lambda b: -0.5 * jnp.sum(b**2) / 100.0


def log_lik(beta, batch):
    Xb, yb = batch
    eta = Xb @ beta
    return jnp.sum(yb * eta - jax.nn.softplus(eta))


s = mcmc_tpu.SGLDSettings(
    step_size=2e-5, batch_size=512,
    n_burnin_draws=2000, n_keep_draws=4000,
    decay_gamma=0.33, decay_b=1000.0,     # Welling-Teh polynomial decay
)
out = mcmc_tpu.sgld(jnp.zeros(D), log_prior, log_lik, (X, y), s,
                    n_chains=32, key=jax.random.PRNGKey(1),
                    minibatch="shared")   # one gather/draw: the batched mode
                                          # (~250x per-chain gathers, docs/performance.md)

err = jnp.abs(out.mean - beta_true).max()
print("finite-update rate:", float(out.accept_rate.mean()))  # 1.0 = healthy
print("max |posterior mean - truth|:", float(err))
