"""Target log-kernels used by tests, examples, and benchmarks.

These are pure JAX re-expressions of the reference's example targets
(reference examples/eigen/*.cpp) plus the BASELINE.md benchmark targets
(100-d logistic regression, ill-conditioned Gaussian, banana). All are
vmap/grad/jit safe scalar functions of a parameter vector.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

LOG_2PI = math.log(2.0 * math.pi)
# f32 data products in the GLM targets run at full f32 precision: the GPU
# would otherwise take TF32 (about three decimal digits), and the density
# is what the MH accept test reads
_HIGHEST = jax.lax.Precision.HIGHEST


def gaussian_mean_model(x_data, sigma=1.0, mu_0=1.0, sigma_0=2.0):
    """Gaussian-mean posterior of reference examples/eigen/rwmh_normal_mean.cpp:
    likelihood N(mu, sigma^2) over ``x_data`` plus N(mu_0, sigma_0^2) prior on
    the single parameter mu."""
    x = jnp.asarray(x_data)
    n = x.shape[0]

    def log_kernel(params):
        mu = params[0]
        ll = -n * (0.5 * LOG_2PI + jnp.log(sigma)) \
            - jnp.sum((x - mu) ** 2) / (2.0 * sigma**2)
        lp = -0.5 * LOG_2PI - jnp.log(sigma_0) - (mu - mu_0) ** 2 / (2.0 * sigma_0**2)
        return ll + lp

    return log_kernel


def gaussian_mean_scale_model(x_data):
    """(mu, sigma) likelihood of reference examples/eigen/hmc_normal.cpp:46-62
    — no prior, sigma sampled directly (non-positive sigma yields NaN which
    samplers reject)."""
    x = jnp.asarray(x_data)
    n = x.shape[0]

    def log_kernel(params):
        mu, sigma = params[0], params[1]
        return -n * (0.5 * LOG_2PI + jnp.log(sigma)) \
            - jnp.sum((x - mu) ** 2) / (2.0 * sigma**2)

    return log_kernel


def normal_fisher_metric(n_data: int):
    """Fisher metric for the (mu, sigma) normal model, the RM-HMC example's
    ``tensor_fn`` (reference examples/eigen/rmhmc_normal.cpp:78-111):
    G = diag(n/sigma^2, 2n/sigma^2). Derivatives are obtained by jax.jacfwd
    in the sampler, replacing the hand-coded Cube_t."""

    def metric_fn(params):
        sigma_sq = params[1] ** 2
        return jnp.diag(jnp.array([n_data / sigma_sq, 2.0 * n_data / sigma_sq]))

    return metric_fn


def make_logistic_regression_data(key, n_data: int, dim: int, dtype=jnp.float32):
    """Synthetic logistic-regression data for the BASELINE 100-d benchmark."""
    k1, k2, k3 = jax.random.split(key, 3)
    X = jax.random.normal(k1, (n_data, dim), dtype) / jnp.sqrt(dim).astype(dtype)
    beta_true = jax.random.normal(k2, (dim,), dtype)
    logits = X @ beta_true
    y = (jax.random.uniform(k3, (n_data,), dtype) < jax.nn.sigmoid(logits)).astype(dtype)
    return X, y, beta_true


def logistic_regression_model(X, y, prior_scale=10.0, matmul_dtype=None):
    """Bayesian logistic regression: Bernoulli likelihood with N(0, s^2)
    prior. The hot op is the (n_chains, dim) x (dim, n_data) product that
    XLA hands to the GPU's matrix library when the kernel is vmapped over
    chains.

    With ``matmul_dtype=None`` the product runs in f32 at
    ``precision=HIGHEST`` — no TF32 on the GPU — so the density is the one
    the CPU tests pin (1e-5 relative to float64). ``matmul_dtype=
    jnp.bfloat16`` runs it in bf16 with f32 accumulation on the tensor
    cores: the density the sampler's accept test reads is then the bf16
    one.
    """
    X = jnp.asarray(X)
    y = jnp.asarray(y)
    Xm = X.astype(matmul_dtype) if matmul_dtype is not None else X

    def log_kernel(beta):
        if matmul_dtype is not None:
            logits = jnp.dot(Xm, beta.astype(matmul_dtype),
                             preferred_element_type=jnp.float32)
        else:
            logits = jnp.dot(X, beta, precision=_HIGHEST)
        ll = jnp.sum(y * logits - jax.nn.softplus(logits))
        lp = -0.5 * jnp.sum(beta**2) / prior_scale**2
        return ll + lp

    return log_kernel


def ill_conditioned_gaussian(dim: int, condition_number: float = 1e4, dtype=jnp.float32):
    """Zero-mean Gaussian with log-spaced marginal variances spanning the
    given condition number — the BASELINE NUTS stress target."""
    variances = jnp.logspace(0.0, jnp.log10(condition_number), dim, dtype=dtype)

    def log_kernel(x):
        return -0.5 * jnp.sum(x * x / variances)

    log_kernel.variances = variances
    return log_kernel


def banana_model(b: float = 0.1, sigma: float = 10.0):
    """2-d banana (twisted Gaussian): x1 ~ N(0, sigma^2),
    x2 | x1 ~ N(b * (x1^2 - sigma^2), 1)."""

    def log_kernel(x):
        x1, x2 = x[0], x[1]
        return -0.5 * x1**2 / sigma**2 - 0.5 * (x2 - b * (x1**2 - sigma**2)) ** 2

    return log_kernel


def gaussian_mixture_model(mu, sig_sq, weights):
    """Isotropic Gaussian mixture (reference examples/eigen/aees_mixture.cpp:37-58).

    ``mu`` has shape (n_mix, n_vals); computed with logsumexp instead of the
    reference's probability-space sum for numerical stability — identical up
    to rounding wherever the reference is finite.
    """
    mu = jnp.asarray(mu)
    sig_sq = jnp.asarray(sig_sq)
    weights = jnp.asarray(weights)
    n_vals = mu.shape[1]

    def log_kernel(x):
        dist_sq = jnp.sum((x[None, :] - mu) ** 2, axis=1)
        log_comp = jnp.log(weights) - 0.5 * dist_sq / sig_sq \
            - 0.5 * n_vals * jnp.log(2.0 * jnp.pi * sig_sq)
        return jax.scipy.special.logsumexp(log_comp)

    return log_kernel


def neals_funnel(dim: int = 10, scale: float = 3.0):
    """Neal's funnel: v ~ N(0, scale^2), x_i | v ~ N(0, e^v). The classic
    pathological geometry for step-size/mass adaptation testing."""

    def log_kernel(params):
        v, x = params[0], params[1:]
        lp_v = -0.5 * v**2 / scale**2
        lp_x = -0.5 * jnp.sum(x**2) * jnp.exp(-v) - 0.5 * (dim - 1) * v
        return lp_v + lp_x

    log_kernel.dim = dim
    return log_kernel


def eight_schools_model(y=None, sigma=None, non_centered=True,
                        tau_prior="lognormal"):
    """The eight-schools hierarchical model (Rubin 1981). Parameters are
    ``[mu, log_tau, theta_tilde_1..8]`` (non-centered) or
    ``[mu, log_tau, theta_1..8]`` (centered). 10-dimensional.

    ``tau_prior="half_cauchy"`` uses the Stan-manual prior set
    (mu ~ N(0,5), tau ~ HalfCauchy(0,5)) whose published posterior is
    E[mu] ~ 4.4, E[tau] ~ 3.6 — the reference configuration for
    cross-checking diagnostics; the default keeps the round-1
    log-normal-tau variant."""
    y = jnp.asarray(y) if y is not None else \
        jnp.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = jnp.asarray(sigma) if sigma is not None else \
        jnp.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

    def log_kernel(params):
        mu, log_tau = params[0], params[1]
        tau = jnp.exp(log_tau)
        if tau_prior == "half_cauchy":
            # log p(tau) + log|dtau/dlog_tau| = -log(1 + (tau/5)^2) + log_tau
            lp = -0.5 * (mu / 5.0) ** 2 \
                - jnp.log1p((tau / 5.0) ** 2) + log_tau
        else:
            lp = -0.5 * (mu / 5.0) ** 2 - 0.5 * (log_tau / 5.0) ** 2
        if non_centered:
            theta_t = params[2:]
            theta = mu + tau * theta_t
            lp = lp - 0.5 * jnp.sum(theta_t**2)
        else:
            theta = params[2:]
            lp = lp - 0.5 * jnp.sum((theta - mu) ** 2) / tau**2 - 8.0 * log_tau
        lp = lp - 0.5 * jnp.sum((y - theta) ** 2 / sigma**2)
        return lp

    log_kernel.dim = 10
    return log_kernel


def poisson_regression_model(X, y, prior_scale=5.0):
    """Poisson GLM with log link: y_i ~ Poisson(exp(x_i . beta)); the data
    product runs at ``precision=HIGHEST``."""
    X = jnp.asarray(X)
    y = jnp.asarray(y)

    def log_kernel(beta):
        eta = jnp.dot(X, beta, precision=_HIGHEST)
        ll = jnp.sum(y * eta - jnp.exp(eta))
        return ll - 0.5 * jnp.sum(beta**2) / prior_scale**2

    return log_kernel


def student_t_regression_model(X, y, df=4.0, scale=1.0, prior_scale=10.0):
    """Robust linear regression with Student-t errors; the data product
    runs at ``precision=HIGHEST``."""
    X = jnp.asarray(X)
    y = jnp.asarray(y)

    def log_kernel(beta):
        resid = (y - jnp.dot(X, beta, precision=_HIGHEST)) / scale
        ll = -0.5 * (df + 1.0) * jnp.sum(jnp.log1p(resid**2 / df))
        return ll - 0.5 * jnp.sum(beta**2) / prior_scale**2

    return log_kernel


def horseshoe_regression_model(X, y, sigma=1.0, tau_scale=1.0):
    """Sparse linear regression with the horseshoe prior (Carvalho, Polson,
    Scott 2010), non-centered: parameters are
    ``[beta_tilde_1..p, log_lambda_1..p, log_tau]`` (2p + 1 dims) with
    ``beta_j = beta_tilde_j * lambda_j * tau``, ``lambda_j ~ C+(0,1)``,
    ``tau ~ C+(0, tau_scale)``. The per-coefficient funnel geometry is the
    standard stress test for adaptive HMC/NUTS warmup."""
    X = jnp.asarray(X)
    y = jnp.asarray(y)
    p = X.shape[1]

    def log_kernel(params):
        beta_t = params[:p]
        log_lam = params[p:2 * p]
        log_tau = params[2 * p]
        lam = jnp.exp(log_lam)
        tau = jnp.exp(log_tau)
        beta = beta_t * lam * tau

        ll = -0.5 * jnp.sum((y - X @ beta) ** 2) / sigma**2
        lp = -0.5 * jnp.sum(beta_t**2)                       # non-centered N(0,1)
        # half-Cauchy priors with log-transform Jacobians
        lp = lp + jnp.sum(-jnp.log1p(lam**2) + log_lam)
        lp = lp - jnp.log1p((tau / tau_scale) ** 2) + log_tau
        return ll + lp

    log_kernel.dim = 2 * p + 1
    return log_kernel


def rbf_kernel(xs, length_scale=1.0, amplitude=1.0, jitter=1e-4):
    """Squared-exponential (RBF) Gram matrix over inputs ``xs`` of shape
    ``(n,)`` or ``(n, p)``, with ``jitter * amplitude**2`` on the diagonal
    for Cholesky stability. The prior covariance for the latent-GP models
    below (no reference analog — MCMCLib has no model library at all; its
    targets live in example programs).

    The default jitter is sized for float32: a smooth-kernel Gram matrix
    over tens of points has eigenvalues below f32 resolution, and an
    accelerator Cholesky can return NaN where CPU LAPACK limps through —
    1e-6 was measured indefinite (min eig -3.5e-6) at n=64,
    length_scale=0.5."""
    xs = jnp.asarray(xs)
    if xs.ndim == 1:
        xs = xs[:, None]
    d2 = jnp.sum((xs[:, None, :] - xs[None, :, :]) ** 2, axis=-1)
    n = xs.shape[0]
    return amplitude**2 * (jnp.exp(-0.5 * d2 / length_scale**2)
                           + jitter * jnp.eye(n, dtype=xs.dtype))


def latent_gp_poisson_model(xs, counts, length_scale=1.0, amplitude=1.0,
                            jitter=1e-4):
    """Log-Gaussian Cox-style latent GP with Poisson counts:
    ``f ~ GP(0, RBF)``, ``counts_i ~ Poisson(exp(f_i))``. Returns
    ``(log_lik, prior_cov)`` shaped for :func:`mcmc_tpu.elliptical_slice`
    (which handles the GP prior exactly through the ellipse)."""
    counts = jnp.asarray(counts)
    K = rbf_kernel(xs, length_scale, amplitude, jitter)

    def log_lik(f):
        return jnp.sum(counts * f - jnp.exp(f))

    return log_lik, K


def gp_regression_exact_posterior(K, y, noise_var):
    """Closed-form latent posterior of GP regression with Gaussian noise:
    ``mean = K (K + noise_var I)^-1 y``,
    ``cov = K - K (K + noise_var I)^-1 K`` — the validation anchor for
    the latent-GP samplers."""
    K = jnp.asarray(K)
    y = jnp.asarray(y)
    n = K.shape[0]
    A = K + noise_var * jnp.eye(n, dtype=K.dtype)
    sol = jnp.linalg.solve(A, K)
    return K @ jnp.linalg.solve(A, y), K - K @ sol
