"""Adaptive tempered Sequential Monte Carlo (SMC) sampler.

No reference analog — MCMCLib's population machinery stops at DE-MCMC
(reference src/de.cpp:30-273) and AEES (reference src/aees.cpp:30-305), both
of which are MCMC chains that merely *use* a population. Tempered SMC is the
population-native completion of that family: a particle cloud is annealed
from a tractable initial distribution to the posterior through a sequence of
bridging densities, with importance reweighting, resampling, and MCMC
mutation at each stage (Del Moral, Doucet & Jasra 2006; adaptive tempering
after Jasra et al. 2011). Uniquely among the samplers here it also returns an
estimate of the **log normalizing constant** (model evidence) — a capability
the reference has no answer to.

Anneal path, on the unconstrained space: with ``q0 = N(mu0, diag(s0^2))``
(exactly sampleable, known density) and ``L(z)`` the box log-kernel,

    log pi_lambda(z) = (1 - lambda) * log q0(z) + lambda * L(z),

lambda: 0 -> 1. Stage t does, in order:

1. **Adaptive temperature step**: choose ``lambda_{t+1}`` by bisection so the
   incremental-weight effective sample size ``ESS = (sum w)^2 / sum w^2``
   with ``log w_i = (lambda_{t+1} - lambda_t)(L(z_i) - log q0(z_i))`` equals
   ``ess_target * n_particles`` (takes 1.0 if reachable).
2. **Evidence update**: ``log Z += logsumexp(log w) - log N`` (weights enter
   each stage uniform because stage t-1 resampled).
3. **Resampling**: systematic by default — normalized-weight cumsum against
   a jittered uniform grid via ``jnp.searchsorted``; fully on-device, fixed
   shape, O(N log N).
4. **Mutation**: ``n_mcmc_steps`` Metropolis moves per particle targeting
   ``pi_{lambda_{t+1}}``, vmapped over the cloud — random-walk with the
   *population* covariance Cholesky scaled by the optimal ``2.38/sqrt(d)``
   (inner="rwmh", default), or HMC whitened by the population's per-dimension
   standard deviations (inner="hmc"). The cloud itself provides the
   preconditioner; nothing is hand-tuned per stage.

Accelerator-native design: the entire run is ONE jitted ``lax.while_loop`` over
stages — the bisection (~30 reweightings of an (N,) vector), the cumsum /
searchsorted resampling, the (d, d) population Cholesky, and the vmapped
mutation sweep all stay on device; nothing round-trips the host. Under
``mesh`` the particle axis is sharded and GSPMD turns the reductions
(logsumexp, mean/cov), the resampling cumsum, and the index gather into interconnect
collectives.

Because each bridging density is only ever *sampled approximately*, SMC's
validity rests on the importance weights, not on per-stage chain convergence
— exactly why it excels at the multimodal targets (AEES's raison d'être,
reference examples/eigen/aees_mixture.cpp) where single-chain samplers
stall: separated modes are populated by the cloud at high temperature and
their mass ratio is corrected by the weights, not by rare mode-hopping moves.

For bounded problems everything runs on the unconstrained space (the
annealed kernel includes the log-Jacobian, as in ``samplers/pt.py``) and the
final cloud is back-transformed; ``log_z`` then estimates the *constrained*
-space integral of ``exp(log_kernel)`` since the Jacobian is absorbed by the
change of variables.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import logsumexp

from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import SMCSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["smc", "SMCState", "resample_indices", "next_lambda"]

_BISECT_ITERS = 30


class SMCState(NamedTuple):
    key: jax.Array        # PRNG key
    X: jax.Array          # (N, d) particle positions (unconstrained)
    lk: jax.Array         # (N,) box log-kernel values L(z)
    lq: jax.Array         # (N,) initial-density log q0(z) values
    lam: jax.Array        # current inverse temperature in [0, 1]
    stage: jax.Array      # completed stage count
    log_z: jax.Array      # running evidence estimate
    n_acc: jax.Array      # (N,) accepted mutation moves per particle
    lambdas: jax.Array    # (max_stages,) lambda after each stage
    ess_frac: jax.Array   # (max_stages,) realized incremental ESS fraction
    acc_rate: jax.Array   # (max_stages,) mean mutation acceptance per stage


def _ess_fraction(logw):
    """ESS((w_i)) / N = exp(2 lse(logw) - lse(2 logw)) / N, in log space."""
    n = logw.shape[0]
    return jnp.exp(2.0 * logsumexp(logw) - logsumexp(2.0 * logw)) / n


def next_lambda(lam, delta, ess_target):
    """Largest ``lambda' in (lam, 1]`` with incremental ESS fraction >=
    ``ess_target``, by monotone bisection on ``logw = (lambda'-lam)*delta``.

    ESS is 1 at ``lambda'=lam`` and decreasing in ``lambda'``, so the
    invariant ``ess(lo) >= target`` holds throughout and ``lo`` is returned
    (conservative: the realized ESS is at least the target). Takes 1.0
    outright when ``ess(1.0) >= target`` (the final stage)."""
    f = lambda l: _ess_fraction((l - lam) * delta)

    def body(_, bounds):
        lo, hi = bounds
        mid = 0.5 * (lo + hi)
        ok = f(mid) >= ess_target
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    lo, _ = lax.fori_loop(0, _BISECT_ITERS, body,
                          (lam, jnp.ones_like(lam)))
    lam_new = jnp.where(f(jnp.ones_like(lam)) >= ess_target,
                        jnp.ones_like(lam), lo)
    # guarantee forward progress even under catastrophic weight degeneracy
    # (max_stages still bounds the loop; `completed` reports lam == 1)
    return jnp.minimum(jnp.maximum(lam_new, lam + 1e-5), 1.0)


def resample_indices(key, logw, n, kind="systematic"):
    """Ancestor indices for normalized log-weights ``logw``.

    systematic: one uniform offset against the (i + u)/n grid — lowest
    variance, the default; stratified: per-slot offsets (i + u_i)/n;
    multinomial: n iid lookups. All are a cumsum + ``searchsorted`` —
    fixed-shape, on-device, no host sync."""
    w = jnp.exp(logw - logsumexp(logw))
    c = jnp.cumsum(w)
    c = c / c[-1]  # guard fp drift so u < c[-1] always resolves in-range
    if kind == "systematic":
        u = (jax.random.uniform(key, (), w.dtype) + jnp.arange(n)) / n
    elif kind == "stratified":
        u = (jax.random.uniform(key, (n,), w.dtype) + jnp.arange(n)) / n
    elif kind == "multinomial":
        u = jax.random.uniform(key, (n,), w.dtype)
    else:
        raise ValueError(f"unknown resample kind {kind!r}")
    return jnp.clip(jnp.searchsorted(c, u, side="right"), 0, n - 1)


def smc(initial_vals, log_kernel, settings=None, *, key=None, mesh=None,
        dtype=None) -> SamplerResult:
    """Run adaptive tempered SMC. Returns the final equally-weighted particle
    cloud as ``draws`` of shape ``(n_particles, n_vals)`` (constrained space)
    — one posterior population, not a chain trace, so there is no
    ``n_chains`` argument; the population axis shards over ``mesh``.

    ``initial_vals`` (shape ``(n_vals,)``) centers the initial cloud
    ``q0 = N(initial_vals', diag(init_scale^2))`` (on the unconstrained
    space; scalar or per-dimension ``init_scale``).

    Diagnostics:
        ``log_z``: log evidence estimate ``log ∫ exp(log_kernel)``.
        ``n_stages``: annealing stages taken.
        ``lambdas`` / ``ess_fraction`` / ``mutation_accept_rate``: per-stage
        schedule, realized incremental ESS, and mutation acceptance
        (length ``n_stages``).
        ``completed``: whether ``lambda`` reached 1 within ``max_stages``.

    ``n_accept_draws`` counts accepted mutation moves per particle over the
    whole run (out of ``n_stages * n_mcmc_steps``); the reference's
    per-draw ``accept_rate`` convention does not apply to SMC.
    """
    algo, s = resolve_settings(settings, "smc_settings", SMCSettings)
    key = resolve_key(key, algo)

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype)
    if not prob.squeeze:
        raise ValueError(
            f"smc takes a single center point initial_vals of shape "
            f"(n_vals,); got a chain-batched array of shape "
            f"{tuple(jnp.shape(initial_vals))} — the population size is "
            f"SMCSettings.n_particles")
    dim, dt, box = prob.n_vals, prob.dtype, prob.box_log_kernel
    N = int(s.n_particles)
    max_stages = int(s.max_stages)
    n_mcmc = int(s.n_mcmc_steps)
    ess_target = jnp.asarray(s.ess_target, dt)
    if not 0.0 < float(s.ess_target) < 1.0:
        raise ValueError(f"ess_target must be in (0, 1), got {s.ess_target}")
    if s.inner not in ("rwmh", "hmc"):
        raise ValueError(f"inner must be 'rwmh' or 'hmc', got {s.inner!r}")
    if s.resample not in ("systematic", "stratified", "multinomial"):
        raise ValueError(f"unknown resample kind {s.resample!r}")

    mu0 = prob.first_draw[0]
    s0 = jnp.broadcast_to(jnp.asarray(s.init_scale, dt), (dim,))

    def lq_fn(z):
        r = (z - mu0) / s0
        return -0.5 * jnp.dot(r, r) - jnp.sum(jnp.log(s0)) \
            - 0.5 * dim * jnp.log(2.0 * jnp.pi).astype(dt)

    def lk_safe(z):
        v = box(z)
        return jnp.where(jnp.isfinite(v), v, -jnp.inf)

    rw_scale = jnp.asarray(s.par_scale * 2.38 / jnp.sqrt(dim), dt)

    def mutation_sweep(key, X, lk, lq, lam):
        """n_mcmc Metropolis moves targeting pi_lam, preconditioned by the
        population's own spread (computed once per stage)."""
        mean = X.mean(axis=0)
        Xc = X - mean
        if s.inner == "rwmh":
            C = (Xc.T @ Xc) / N
            C = C + (1e-6 * jnp.trace(C) / dim + 1e-12) * jnp.eye(dim, dtype=dt)
            L = jnp.linalg.cholesky(C)
        else:
            sd = jnp.sqrt((Xc * Xc).mean(axis=0) + 1e-12)

        def logp(z, lkv, lqv):
            return (1.0 - lam) * lqv + lam * lkv

        def rwmh_move(key, x, lkv, lqv):
            k_n, k_u = jax.random.split(key)
            prop = x + rw_scale * (L @ jax.random.normal(k_n, (dim,), dt))
            lk_p, lq_p = lk_safe(prop), lq_fn(prop)
            d = logp(prop, lk_p, lq_p) - logp(x, lkv, lqv)
            acc = jnp.log(jax.random.uniform(k_u, dtype=dt)) \
                < jnp.minimum(0.0, d)
            return (jnp.where(acc, prop, x), jnp.where(acc, lk_p, lkv),
                    jnp.where(acc, lq_p, lqv), acc)

        grad_pi = jax.grad(lambda z: (1.0 - lam) * lq_fn(z) + lam * box(z))

        def hmc_move(key, x, lkv, lqv):
            # whitened leapfrog: mass M = diag(1/sd^2), p~N(0,I) in the
            # whitened frame; dH uses the whitened kinetic energy directly
            k_m, k_u = jax.random.split(key)
            eps = jnp.asarray(s.step_size, dt)
            p0 = jax.random.normal(k_m, (dim,), dt)

            def leap(carry, _):
                z, p, g = carry
                p = p + 0.5 * eps * sd * g
                z = z + eps * sd * p
                g = grad_pi(z)
                p = p + 0.5 * eps * sd * g
                return (z, p, g), None

            (z, p, _), _ = lax.scan(leap, (x, p0, grad_pi(x)), None,
                                    length=int(s.n_leap_steps))
            lk_p, lq_p = lk_safe(z), lq_fn(z)
            dH = logp(z, lk_p, lq_p) - logp(x, lkv, lqv) \
                - 0.5 * (jnp.dot(p, p) - jnp.dot(p0, p0))
            acc = jnp.log(jax.random.uniform(k_u, dtype=dt)) \
                < jnp.minimum(0.0, dH)
            return (jnp.where(acc, z, x), jnp.where(acc, lk_p, lkv),
                    jnp.where(acc, lq_p, lqv), acc)

        move = rwmh_move if s.inner == "rwmh" else hmc_move

        def body(carry, _):
            key, X, lk, lq, acc_n = carry
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, N)
            X, lk, lq, acc = jax.vmap(move)(keys, X, lk, lq)
            return (key, X, lk, lq, acc_n + acc), acc.mean()

        (key, X, lk, lq, acc_n), accs = lax.scan(
            body, (key, X, lk, lq, jnp.zeros((N,), jnp.int32)), None,
            length=n_mcmc)
        return key, X, lk, lq, acc_n, accs.mean()

    def stage_step(st: SMCState) -> SMCState:
        delta = st.lk - st.lq
        lam_new = next_lambda(st.lam, delta, ess_target)
        logw = (lam_new - st.lam) * delta
        log_z = st.log_z + logsumexp(logw) - jnp.log(jnp.asarray(N, dt))

        key, k_res = jax.random.split(st.key)
        idx = resample_indices(k_res, logw, N, s.resample)
        X, lk, lq = st.X[idx], st.lk[idx], st.lq[idx]

        key, X, lk, lq, acc_n, acc_mean = mutation_sweep(
            key, X, lk, lq, lam_new)

        i = st.stage
        return SMCState(
            key=key, X=X, lk=lk, lq=lq, lam=lam_new, stage=i + 1,
            log_z=log_z, n_acc=st.n_acc + acc_n,
            lambdas=st.lambdas.at[i].set(lam_new),
            ess_frac=st.ess_frac.at[i].set(_ess_fraction(logw)),
            acc_rate=st.acc_rate.at[i].set(acc_mean),
        )

    def run(key, X0):
        lk0 = jax.vmap(lk_safe)(X0)
        lq0 = jax.vmap(lq_fn)(X0)
        st = SMCState(
            key=key, X=X0, lk=lk0, lq=lq0,
            lam=jnp.zeros((), dt), stage=jnp.zeros((), jnp.int32),
            log_z=jnp.zeros((), dt), n_acc=jnp.zeros((N,), jnp.int32),
            lambdas=jnp.zeros((max_stages,), dt),
            ess_frac=jnp.zeros((max_stages,), dt),
            acc_rate=jnp.zeros((max_stages,), dt),
        )
        return lax.while_loop(
            lambda st: (st.lam < 1.0) & (st.stage < max_stages),
            stage_step, st)

    key, k_init = jax.random.split(key)
    X0 = mu0 + s0 * jax.random.normal(k_init, (N, dim), dt)

    if mesh is not None:
        from mcmc_tpu.parallel.mesh import shard_chain_axis
        X0 = shard_chain_axis(X0, mesh)
        run = jax.jit(run)
    final = run(key, X0)

    draws = common.finalize_draws(final.X, prob)
    n_stages = int(final.stage)
    return SamplerResult(
        draws=draws,
        n_accept_draws=final.n_acc,
        diagnostics={
            "log_z": final.log_z,
            "n_stages": n_stages,
            "completed": bool(final.lam >= 1.0),
            "lambdas": final.lambdas[:n_stages],
            "ess_fraction": final.ess_frac[:n_stages],
            "mutation_accept_rate": final.acc_rate[:n_stages],
        },
    )
