"""Tall-data parallelism: shard the LIKELIHOOD, not just the chains.

A (chains, data) grid mesh runs every log-density/gradient evaluation
across the data-axis devices with an XLA-inserted all-reduce — within-draw
parallelism the reference's OpenMP-over-chains model cannot express
(SURVEY.md §2d). On one host this demo uses 8 virtual CPU devices; on a
pod slice the same code spans real chips over the interconnect.
"""

from _common import setup

jax = setup()
import jax.numpy as jnp

import mcmc_tpu
from mcmc_tpu import parallel

n_dev = jax.device_count()
n_data_dev = max(n_dev // 2, 1)
mesh = parallel.make_grid_mesh(min(2, n_dev // n_data_dev), n_data_dev)
print("mesh:", mesh)

# tall synthetic logistic regression
N, D = 32768, 32
k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
X = jax.random.normal(k1, (N, D))
beta_true = jax.random.normal(k2, (D,)) * 0.5
y = (jax.random.uniform(k3, (N,)) < jax.nn.sigmoid(X @ beta_true)).astype(jnp.float32)


def log_kernel_of_data(beta, data):
    Xa, ya = data
    eta = Xa @ beta
    return jnp.sum(ya * eta - jax.nn.softplus(eta)) - 0.5 * jnp.sum(beta**2) / 100.0


# observation axis sharded over the mesh's "data" axis; chains over "chains"
log_kernel = parallel.data_parallel_kernel(log_kernel_of_data, (X, y), mesh)

out = mcmc_tpu.hmc(
    jnp.zeros(D), log_kernel,
    mcmc_tpu.HMCSettings(step_size=0.01, n_leap_steps=16,
                         n_burnin_draws=300, n_keep_draws=500),
    n_chains=8, key=jax.random.PRNGKey(1), mesh=mesh,
)

err = jnp.abs(out.mean - beta_true).max()
print("accept:", float(out.accept_rate.mean()))
print("max |posterior mean - truth|:", float(err))
