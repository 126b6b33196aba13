"""Sampler-surface drivers for the batched HMC steps of
:mod:`mcmc_tpu.ops.fused_logreg`.

That module provides a GLM HMC transition whose whole leapfrog trajectory
runs inside one Pallas kernel, and a multivariate-Gaussian transition whose
leapfrog is a plain ``lax.fori_loop``. These wrappers
put them behind the standard entry-point contract — burn-in + keep scan,
``SamplerResult`` with draws ``(n_keep, n_chains, dim)`` and acceptance —
so the BASELINE suite configs (and users with GLM / multivariate-Gaussian
targets) get the fused path with one call.

The fused steps are fixed-step/fixed-trajectory (reference src/hmc.cpp
semantics: constant ``step_size``/``n_leap_steps``); there is no warmup
adaptation here — pick the step size as with :func:`mcmc_tpu.hmc`, or adapt
with the generic sampler first and pass the adapted value.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu.results import SamplerResult
from mcmc_tpu.ops.fused_logreg import (
    make_fused_hmc_step, make_gaussian_hmc_step)

__all__ = ["fused_glm_hmc", "fused_gaussian_hmc", "run_fused_step"]


def run_fused_step(step, positions, n_burnin, n_keep, key,
                   steps_per_draw: int = 1) -> SamplerResult:
    """Scan a fused batched HMC ``step`` (one PRNG key per transition, the
    ``make_fused_*_hmc_step`` contract) over ``n_burnin`` discarded +
    ``n_keep`` kept draws; ``steps_per_draw=k`` thins by k transitions per
    stored row. Returns constrained-space draws trimmed to the model dim
    (padding columns dropped)."""
    dim = step.dim
    state0 = step.init(jnp.asarray(positions, jnp.float32))
    spd = int(steps_per_draw)

    def one(carry, _):
        st, k = carry
        k, sub = jax.random.split(k)
        st, info = step(sub, st)
        return (st, k), info["accepted"]

    def draw(carry, _):
        acc = None
        for _i in range(spd):
            carry, acc = one(carry, None)
        st, _k = carry
        return carry, (st.position[:, :dim], acc)

    def burn(carry, _):
        carry, _out = draw(carry, None)
        return carry, None

    @jax.jit
    def run(state0, key):
        carry = (state0, key)
        if n_burnin > 0:
            carry, _ = lax.scan(burn, carry, None, length=n_burnin)
        carry, (draws, accepted) = lax.scan(draw, carry, None, length=n_keep)
        return draws, accepted

    draws, accepted = run(state0, key)
    return SamplerResult(
        draws=draws,
        n_accept_draws=accepted.sum(axis=0),
        diagnostics={"accept_rate_per_chain":
                     accepted.astype(jnp.float32).mean(axis=0)},
    )


def fused_glm_hmc(X, y, *, link="logistic", prior_scale=10.0, step_size=0.05,
                  n_leap=8, n_chains=2048, n_burnin_draws=500,
                  n_keep_draws=1000, init_scale=0.05, key=None,
                  interpret=False, steps_per_draw=1) -> SamplerResult:
    """Fused-trajectory HMC on a GLM posterior ``y | X beta ~ family(link)``
    with a ``N(0, prior_scale^2)`` prior — logistic / poisson / linear /
    probit built in, :func:`mcmc_tpu.ops.fused_logreg.studentt_link` (or any
    callable link) pluggable. The whole ``n_leap`` trajectory runs in one
    Pallas kernel per block of chains (see the fused_logreg module
    docstring); ``interpret=True`` runs it in the Pallas interpreter, for
    tests on the CPU."""
    key = jax.random.PRNGKey(0) if key is None else key
    k_init, k_run = jax.random.split(key)
    step = make_fused_hmc_step(X, y, prior_scale=prior_scale,
                               step_size=step_size, n_leap=n_leap,
                               interpret=interpret, link=link)
    pos0 = init_scale * jax.random.normal(k_init, (n_chains, step.dim),
                                          jnp.float32)
    return run_fused_step(step, pos0, n_burnin_draws, n_keep_draws, k_run,
                          steps_per_draw)


def fused_gaussian_hmc(precision, mean=None, *, step_size=0.5, n_leap=32,
                       n_chains=2048, n_burnin_draws=500, n_keep_draws=1000,
                       init_scale=0.05, key=None, steps_per_draw=1,
                       step_jitter=0.2) -> SamplerResult:
    """Batched HMC on a multivariate Gaussian ``N(mean, P^{-1})`` given the
    precision ``P`` (dense or diagonal) — the natural engine for the
    ill-conditioned BASELINE stress config where long jittered-step
    trajectories carry the slow directions (``step_jitter`` breaks the
    fixed-angle resonances an exactly quadratic target otherwise hits — see
    :func:`mcmc_tpu.ops.fused_logreg.make_gaussian_hmc_step`)."""
    key = jax.random.PRNGKey(0) if key is None else key
    k_init, k_run = jax.random.split(key)
    step = make_gaussian_hmc_step(precision, mean, step_size=step_size,
                                  n_leap=n_leap, step_jitter=step_jitter)
    pos0 = init_scale * jax.random.normal(k_init, (n_chains, step.dim),
                                          jnp.float32)
    return run_fused_step(step, pos0, n_burnin_draws, n_keep_draws, k_run,
                          steps_per_draw)
