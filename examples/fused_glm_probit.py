"""Fused-Pallas GLM HMC: probit regression and Student-t robust regression.

The fused path runs the whole leapfrog trajectory inside one Pallas kernel
on the Triton route (design-matrix tiles streamed from L2, bf16 tensor-core
products, f32 state — see mcmc_tpu/ops/fused_logreg.py), so this example
needs a GPU. Beyond the canonical links the reference's examples cover
(logistic — reference examples/autodiff/hmc_normal_autodiff.cpp is the
closest analog), the link slot takes non-canonical families: probit (built
in; erf via the A&S 7.1.26 polynomial, since Pallas's Triton lowering has no
erf rule) and Student-t robust regression (``studentt_link(nu)``), or any
callable ``link(eta, y) -> (mu_eff, ll_terms)``.
"""

from _common import setup

jax = setup()
import jax.numpy as jnp
import numpy as np

from mcmc_tpu.device import require_accelerator
from mcmc_tpu.ops import fused_glm_hmc, studentt_link
from mcmc_tpu import diagnostics

require_accelerator("gpu")
kw = dict(n_chains=512)

# --- probit regression -----------------------------------------------------
k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
n, d = 500, 25
X = jax.random.normal(k1, (n, d)) * 0.5
beta_true = jax.random.normal(k2, (d,)) * 0.8
ndtr = lambda e: 0.5 * (1.0 + jax.lax.erf(e / jnp.sqrt(2.0)))
y = (jax.random.uniform(k3, (n,)) < ndtr(X @ beta_true)).astype(jnp.float32)

out = fused_glm_hmc(X, y, link="probit", step_size=0.06, n_leap=8,
                    n_burnin_draws=500, n_keep_draws=1000,
                    key=jax.random.PRNGKey(1), **kw)
est = np.asarray(out.draws).reshape(-1, d).mean(axis=0)
print("probit: corr(posterior mean, truth) =",
      round(float(np.corrcoef(est, np.asarray(beta_true))[0, 1]), 3))
print("        accept rate =",
      round(float(out.diagnostics['accept_rate_per_chain'].mean()), 3),
      " max rank R-hat =",
      round(float(diagnostics.rank_normalized_rhat(out.draws).max()), 4))

# --- Student-t robust regression (nu = 4, heavy-tailed noise) ---------------
k4, k5 = jax.random.split(jax.random.PRNGKey(10))
y_t = X @ beta_true + 0.5 * jax.random.t(k4, 4.0, (n,))
out_t = fused_glm_hmc(X, y_t, link=studentt_link(4.0), step_size=0.05,
                      n_leap=8, n_burnin_draws=500, n_keep_draws=1000,
                      key=k5, **kw)
est_t = np.asarray(out_t.draws).reshape(-1, d).mean(axis=0)
print("student-t: corr(posterior mean, truth) =",
      round(float(np.corrcoef(est_t, np.asarray(beta_true))[0, 1]), 3))
print("           accept rate =",
      round(float(out_t.diagnostics['accept_rate_per_chain'].mean()), 3))
