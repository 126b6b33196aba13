"""Probability-density helpers.

Vectorized analogs of the reference's ``stats_mcmc`` namespace
(reference include/stats/dnorm.hpp:90-206, dmvnorm.hpp:28-54). The MVN
log-pdf is used by MALA's proposal-asymmetry correction
(reference include/mcmc/mala.ipp:30-70).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

__all__ = ["dnorm", "dmvnorm", "LOG_2PI", "gumbel_topk"]

LOG_2PI = math.log(2.0 * math.pi)


def dnorm(x, mu=0.0, sigma=1.0, log=False):
    """Normal density (reference dnorm.hpp:90-206), element-wise.

    The reference's inf/NaN ladder reduces to IEEE arithmetic here: a
    zero-width sigma yields +inf at x == mu and 0 elsewhere, and non-finite
    inputs propagate NaN, matching the observable behavior of the C++
    constexpr ladder for the cases samplers exercise.
    """
    x = jnp.asarray(x)
    z = (x - mu) / sigma
    log_pdf = -0.5 * LOG_2PI - jnp.log(sigma) - 0.5 * z * z
    return log_pdf if log else jnp.exp(log_pdf)


def dmvnorm(x, mu, sigma, log=False):
    """Multivariate-normal (log-)density (reference dmvnorm.hpp:28-54).

    ``sigma`` may be a scalar (isotropic), a 1-D array (diagonal), or a 2-D
    covariance matrix; the matrix path uses a Cholesky solve rather than the
    reference's explicit ``QUAD_FORM_INV`` + ``LOG_DET`` for stability and
    batching-friendliness on an accelerator.
    """
    x = jnp.asarray(x)
    mu = jnp.asarray(mu, x.dtype)
    k = x.shape[-1]
    cent = x - mu
    sigma = jnp.asarray(sigma, x.dtype)

    if sigma.ndim < 2:
        var = jnp.broadcast_to(sigma, (k,))
        quad = jnp.sum(cent * cent / var, axis=-1)
        logdet = jnp.sum(jnp.log(var))
    else:
        chol = jnp.linalg.cholesky(sigma)
        w = jnp.linalg.solve(chol, cent[..., None])[..., 0] if cent.ndim > 1 else \
            jnp.linalg.solve(chol, cent)
        quad = jnp.sum(w * w, axis=-1)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))

    ret = -0.5 * k * LOG_2PI - 0.5 * (logdet + quad)
    if not log:
        ret = jnp.exp(ret)
        ret = jnp.where(jnp.isinf(ret), jnp.finfo(x.dtype).max, ret)
    return ret


def gumbel_topk(key, log_weights, n):
    """Indices of ``n`` draws WITHOUT replacement proportional to
    ``exp(log_weights)`` via the Gumbel top-k trick (no reference analog —
    shared by the Pathfinder and nested-sampling resamplers)."""
    import jax
    g = -jnp.log(-jnp.log(jax.random.uniform(
        key, log_weights.shape, log_weights.dtype,
        minval=1e-12, maxval=1.0)))
    return jnp.argsort(log_weights + g)[::-1][: int(n)]
