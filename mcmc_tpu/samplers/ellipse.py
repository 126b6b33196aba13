"""Elliptical slice sampling (Murray, Adams & MacKay 2010).

Beyond-reference sampler: the tuning-free workhorse for latent-Gaussian
models — GP regression/classification, Gaussian random fields, any target
of the form ``posterior(x) ∝ N(x; mu, Sigma) * exp(log_lik(x))``. No
reference analog — MCMCLib has no slice sampler and nothing that exploits
a Gaussian-prior factorization; its gradient-free options (RWMH/DE) need a
proposal scale tuned to the prior's geometry, which for a correlated
high-dimensional GP prior is exactly the hard part. Elliptical slice
sampling has ZERO free parameters, every draw moves (it is a slice
sampler: the shrinking bracket always terminates at an acceptable point),
and proposals traverse the ellipse ``x cos(theta) + nu sin(theta)`` that
the prior itself defines — prior-correlation-aware moves for free.

One draw (the paper's Fig. 2):

    nu    ~ N(0, Sigma)                       (one prior draw)
    log_y = log_lik(x) + log U(0,1)           (slice level)
    theta ~ U(0, 2*pi); bracket [theta - 2*pi, theta]
    repeat: x' = (x - mu) cos(theta) + nu sin(theta) + mu
            accept if log_lik(x') > log_y
            else shrink the bracket toward 0 and redraw theta

As theta -> 0, x' -> x and log_lik(x) > log_y holds by construction, so
termination is guaranteed in exact arithmetic; ``max_shrink_steps`` is a
safety cap (hitting it leaves the chain in place and reports the draw as
not accepted — ``accept_rate < 1`` is the numerical-health signal, as for
SGLD).

Accelerator-native design: the shrink loop is a ``lax.while_loop`` vmapped over
chains — iterations run lockstep across the chain batch (every chain pays
the slowest chain's bracket), but the loop is short (typically 2-8
likelihood evaluations) and each iteration is ONE batched likelihood eval
across all chains, so the matrix and vector units stay fed. The prior draw ``nu`` uses the
same trace-time SPD specialization as every other sampler (identity /
diagonal / dense Cholesky, precomputed once). Composes with ``mesh=``
chain sharding, ``checkpoint_dir``, ``thin``, and ``return_resume`` via
the common run loop.

Box constraints are rejected: the Gaussian prior defines the sampling
geometry, so a constrained-space transform would destroy the ellipse's
exactness. Encode constraints in ``log_lik`` (returning ``-inf`` outside
the feasible set keeps correctness — the slice shrinks past infeasible
arcs) or reparameterize.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import EllipticalSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["elliptical_slice", "EllipticalSliceState",
           "build_elliptical_kernel"]

_TWO_PI = 2.0 * math.pi


class EllipticalSliceState(NamedTuple):
    position: jax.Array   # (n_vals,) — the prior's own coordinates
    log_lik: jax.Array    # log_lik at position (-inf if non-finite)


def build_elliptical_kernel(log_lik, mu, spd: common.SPD, n_vals: int,
                            dtype, max_steps: int):
    """Returns ``(init, step)``; ``step`` is the pure single-chain
    transition ``(key, state) -> (state, info)`` with info entries
    ``accepted`` (slice point found before the cap) and ``shrink_steps``
    (likelihood evaluations spent)."""
    max_steps = int(max_steps)

    def _ll(x):
        v = log_lik(x)
        return jnp.where(jnp.isfinite(v), v, -jnp.inf)

    def init(position):
        return EllipticalSliceState(position=position, log_lik=_ll(position))

    def step(key, state: EllipticalSliceState):
        k_nu, k_u, k_t, k_loop = jax.random.split(key, 4)
        nu = spd.sqrt_mv(jax.random.normal(k_nu, (n_vals,), dtype))
        log_y = state.log_lik + jnp.log(
            jax.random.uniform(k_u, dtype=dtype))
        theta0 = jax.random.uniform(k_t, dtype=dtype) * _TWO_PI
        x_c = state.position - mu

        def cond(c):
            done, it = c[0], c[1]
            return jnp.logical_and(~done, it < max_steps)

        def body(c):
            done, it, theta, lo, hi, k, xp, llp = c
            x_prop = x_c * jnp.cos(theta) + nu * jnp.sin(theta) + mu
            ll = _ll(x_prop)
            # freeze lanes that already found their slice point: under
            # vmap the loop runs until ALL lanes finish, and a done lane
            # must not re-accept from its (stale) shrunk bracket
            ok = jnp.logical_and(~done, ll > log_y)
            xp = jnp.where(ok, x_prop, xp)
            llp = jnp.where(ok, ll, llp)
            lo = jnp.where(theta < 0.0, theta, lo)
            hi = jnp.where(theta >= 0.0, theta, hi)
            k, sub = jax.random.split(k)
            theta = jax.random.uniform(sub, dtype=dtype, minval=lo,
                                       maxval=hi)
            return (done | ok, it + 1, theta, lo, hi, k, xp, llp)

        carry = (jnp.asarray(False), jnp.asarray(0, jnp.int32),
                 theta0, theta0 - _TWO_PI, theta0, k_loop,
                 state.position, state.log_lik)
        done, it, _t, _lo, _hi, _k, xp, llp = lax.while_loop(
            cond, body, carry)
        return (EllipticalSliceState(position=xp, log_lik=llp),
                {"accepted": done, "shrink_steps": it})

    return init, step


def elliptical_slice(initial_vals, log_lik, settings=None, *,
                     prior_mean=None, prior_cov=None, n_chains=None,
                     key=None, mesh=None, checkpoint_dir=None,
                     checkpoint_every=500, dtype=None, thin=1,
                     return_resume=False) -> SamplerResult:
    """Run elliptical slice sampling on
    ``posterior(x) ∝ N(x; prior_mean, prior_cov) * exp(log_lik(x))``.

    ``log_lik(params) -> scalar`` is a pure JAX function (close over data);
    the Gaussian-prior factor is NOT part of it — the sampler handles the
    prior exactly through the ellipse. ``prior_mean`` defaults to zeros;
    ``prior_cov`` is ``None`` (identity), a scalar, a 1-D diagonal, or a
    2-D dense SPD matrix (Cholesky precomputed once).

    There are no step sizes, scales, or mass matrices to tune, and every
    draw moves (``accept_rate == 1`` unless the ``max_shrink_steps``
    safety cap binds — the numerical-health signal).
    ``diagnostics["mean_shrink_steps"]`` reports the average number of
    likelihood evaluations per draw (typically 2-8).

    All the usual driver options apply (``n_chains``/``mesh``/
    ``checkpoint_dir``/``thin``/``return_resume``). Box constraints
    (``vals_bound``) are rejected — see the module docstring.
    """
    algo, s = resolve_settings(settings, "elliptical_settings",
                               EllipticalSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if algo.vals_bound:
        raise ValueError(
            "elliptical_slice does not support vals_bound: the Gaussian "
            "prior defines the sampling geometry; return -inf from log_lik "
            "outside the feasible set, or reparameterize")
    if int(s.max_shrink_steps) < 1:
        raise ValueError(f"max_shrink_steps must be >= 1, got "
                         f"{s.max_shrink_steps}")

    prob = common.setup_problem(initial_vals, log_lik, algo, n_chains, dtype)
    spd = common.make_spd(prior_cov, prob.n_vals, prob.dtype)
    mu = jnp.zeros((prob.n_vals,), prob.dtype) if prior_mean is None \
        else jnp.broadcast_to(
            jnp.asarray(prior_mean, prob.dtype), (prob.n_vals,))

    init, step = build_elliptical_kernel(
        prob.box_log_kernel, mu, spd, prob.n_vals, prob.dtype,
        s.max_shrink_steps)
    state0 = jax.vmap(init)(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            key, state0, step, n_burnin, n_keep,
            collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin,
        )
        n_accept = common.tally_accepts(infos)
        diagnostics = {}
        if "shrink_steps" in infos:
            diagnostics["mean_shrink_steps"] = \
                infos["shrink_steps"].mean(axis=0)
        elif "shrink_steps" in infos.get("totals", {}):
            diagnostics["mean_shrink_steps"] = \
                jnp.asarray(infos["totals"]["shrink_steps"],
                            prob.dtype) / n_keep
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {k: v[0] for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
