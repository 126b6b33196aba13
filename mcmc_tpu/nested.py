"""Nested sampling — evidence and posterior from a prior-transform model.

No reference analog — MCMCLib has no evidence machinery at all; this
completes the framework's evidence family (SMC particle estimate,
power-posterior TI/stepping-stone in evidence.py, the Laplace shortcut)
with the estimator of record for multimodal and phase-transition problems:
Skilling (2006) nested sampling, in the batched random-walk variant of
MultiNest/dynesty ('rwalk').

The algorithm compresses the prior through nested likelihood shells: with
``N`` live points drawn from the prior, repeatedly kill the worst-likelihood
points and replace them with new prior draws constrained to exceed the kill
threshold. The enclosed prior mass after the ``j``-th sequential kill
shrinks by ``E[log t] = -1/(N-j)`` (order statistics of uniforms), giving
the quadrature ``Z = sum_j L_j * (X_{j-1} - X_j)`` over dead points.

Accelerator-native design — the classic algorithm is irreducibly sequential one
kill at a time; this implementation batches it:

- **batch kills**: each round removes the ``kill_frac * N`` worst points at
  once with the exact sequential shrinkage ``-sum_i 1/(N-i)`` (a cumsum,
  not a loop) and replaces them all in parallel — every replacement targets
  the hard constraint ``L > L*`` at the batch maximum, above which both
  survivors and replacements are uniform, so the invariant is preserved;
- **constrained replacement** is ``walks`` fixed Metropolis steps in the
  unit-cube prior coordinates (``u``-space), started at random survivors,
  with proposals shaped by the live-point covariance (Cholesky) and a
  global scale Robbins-Monro-tuned to ~50% in-region acceptance — one
  ``(B, walks)``-batched kernel, no per-point loop;
- the whole run is one ``lax.while_loop`` of fixed-shape rounds writing
  dead points into a preallocated buffer; the only host sync is the final
  result.

The model interface is the standard NS pair (as in MultiNest/dynesty):
``prior_transform(u) -> theta`` mapping the unit cube to the prior, and
``log_lik(theta)``. Termination when the live set's maximum possible
remaining contribution ``X * max L`` drops below ``stop_frac`` of the
accumulated evidence. The information ``H = int post ln(post/prior)`` gives
the classic ``sqrt(H/N)`` error bar.

Returned draws carry log-weights ``log w_j = log L_j + log dX_j - log Z``;
``NestedResult.posterior_draws`` resamples them to an equal-weight set
(Gumbel top-k, without replacement).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["nested_sampling", "NestedResult"]


@dataclasses.dataclass
class NestedResult:
    """Nested-sampling output.

    Attributes:
        log_z: log evidence estimate.
        log_z_err: classic ``sqrt(H / n_live)`` uncertainty.
        h: information (nats) — prior-to-posterior compression.
        samples: ``(n_dead + n_live, n_vals)`` all visited points in
            parameter (theta) space, dead first.
        log_w: normalized log importance weights of ``samples``.
        log_l: log-likelihood of each sample.
        n_like_evals: total constrained log-likelihood evaluations.
        n_rounds: batch rounds executed.
        accept_rate: final in-region Metropolis acceptance of the
            replacement walker (healthy ~0.2-0.6).
        converged: True if the termination criterion was met before the
            round cap.
    """

    log_z: Any
    log_z_err: Any
    h: Any
    samples: Any
    log_w: Any
    log_l: Any
    n_like_evals: int
    n_rounds: int
    accept_rate: Any
    converged: bool

    def posterior_draws(self, key, n_draws: int):
        """Equal-weight posterior draws: Gumbel top-k resampling of
        ``samples`` by ``log_w`` without replacement."""
        from mcmc_tpu.stats import gumbel_topk
        return self.samples[gumbel_topk(key, self.log_w, int(n_draws))]


def nested_sampling(prior_transform: Callable, log_lik: Callable, n_vals: int,
                    *, n_live=1024, kill_frac=0.125, walks=24,
                    max_rounds=2000, stop_frac=1e-3, key=None,
                    dtype=jnp.float32) -> NestedResult:
    """Run batched nested sampling (module docstring).

    ``prior_transform(u)`` maps a ``(n_vals,)`` unit-cube point to the
    prior (e.g. ``lambda u: lb + (ub - lb) * u`` for a uniform prior, or
    ``mu + sd * ndtri(u)`` for a Gaussian); ``log_lik(theta)`` is the pure
    log-likelihood. Both are vmapped internally. ``n_live`` controls
    resolution (error ~ ``sqrt(H/n_live)``); ``kill_frac`` the batch
    parallelism per round; ``walks`` the constrained-replacement Metropolis
    steps (raise it if ``accept_rate`` collapses or evidence is biased
    high); ``stop_frac`` the remaining-evidence termination threshold.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    N = int(n_live)
    B = max(int(round(N * float(kill_frac))), 1)
    if B >= N:
        raise ValueError(f"kill_frac {kill_frac} leaves no survivors "
                         f"(n_live={N}, batch={B})")
    d = int(n_vals)
    T = int(max_rounds)
    walks = int(walks)

    pt = jax.vmap(prior_transform)
    ll_batch = jax.vmap(lambda u: log_lik(prior_transform(u)))

    # exact sequential shrinkage for a batch of B kills from N live points:
    # log t_j = -1/(N - j), j = 0..B-1 (cumulative within the round)
    dlogt = -1.0 / (N - jnp.arange(B, dtype=dtype))
    cum_dlogt = jnp.cumsum(dlogt)                       # (B,)
    round_shrink = cum_dlogt[-1]

    neg_inf = jnp.asarray(-jnp.inf, dtype)

    def replace_batch(key, u_start, L_start, live_u, L_star, scale):
        """B constrained random walks of `walks` Metropolis steps in
        u-space: uniform above L_star (out-of-cube or L <= L_star
        rejects). Proposal = live-point covariance Cholesky * scale.
        ``L_start`` carries the start points' already-known likelihoods
        (they are survivors) — no re-evaluation."""
        mu = live_u.mean(axis=0)
        cent = live_u - mu
        cov = cent.T @ cent / (live_u.shape[0] - 1) \
            + 1e-10 * jnp.eye(d, dtype=dtype)
        chol = jnp.linalg.cholesky(cov)

        def one_step(carry, k):
            u, L = carry
            k_n, k_a = jax.random.split(k)
            z = jax.random.normal(k_n, u.shape, dtype)
            prop = u + scale * (z @ chol.T)
            inbox = jnp.all((prop > 0.0) & (prop < 1.0), axis=1)
            Lp = jnp.where(inbox, ll_batch(jnp.clip(prop, 1e-7, 1 - 1e-7)),
                           neg_inf)
            acc = inbox & (Lp > L_star)
            u = jnp.where(acc[:, None], prop, u)
            L = jnp.where(acc, Lp, L)
            return (u, L), acc.mean(dtype=dtype)

        keys = jax.random.split(key, walks)
        (u_new, L_new), accs = lax.scan(one_step, (u_start, L_start), keys)
        return u_new, L_new, accs.mean()

    def cond(state):
        (_, live_L, logX, logZ, _h, r, done, *_rest) = state
        return (~done) & (r < T)

    def body(state):
        (live_u, live_L, logX, logZ, h, r, done, key, scale,
         dead_u, dead_L, dead_logw, acc_last) = state
        key, k_pick, k_walk = jax.random.split(key, 3)

        order = jnp.argsort(live_L)
        killed = order[:B]
        survivors = order[B:]
        L_killed = live_L[killed]                        # ascending
        L_star = L_killed[-1]

        # dead-point weights: trapezoid dX at the exact sequential X grid
        logX_before = logX + jnp.concatenate(
            [jnp.zeros((1,), dtype), cum_dlogt[:-1]])
        logX_after = logX + cum_dlogt
        # log(X_before - X_after) = logX_before + log1p(-exp(dlogt))
        log_dX = logX_before + jnp.log(-jnp.expm1(dlogt))
        log_wL = L_killed + log_dX                       # unnorm. log(w*L)

        logZ_new = jnp.logaddexp(logZ, jax.scipy.special.logsumexp(log_wL))
        # information update: H = sum w_i/Z lnL_i - lnZ, accumulated in the
        # standard streaming form (Skilling 2006)
        dZ_frac = jnp.exp(jax.scipy.special.logsumexp(log_wL) - logZ_new)
        # a killed point with L = -inf (hard-constraint likelihood) carries
        # zero weight; mask it so softmax's 0 * (-inf) cannot NaN-poison H
        wl = jax.nn.softmax(log_wL)
        mean_lnL = jnp.sum(jnp.where(wl > 0, wl * L_killed, 0.0))
        # first round: logZ = -inf makes the carried term 0, not NaN
        carried = jnp.where(jnp.isfinite(logZ),
                            jnp.exp(logZ - logZ_new) * (h + logZ), 0.0)
        h_new = (carried + dZ_frac * mean_lnL) - logZ_new

        # record the killed batch
        dead_u = lax.dynamic_update_slice(dead_u, live_u[killed],
                                          (r * B, 0))
        dead_L = lax.dynamic_update_slice(dead_L, L_killed, (r * B,))
        dead_logw = lax.dynamic_update_slice(dead_logw, log_wL, (r * B,))

        # parallel constrained replacement from random survivors
        start_ix = survivors[jax.random.randint(k_pick, (B,), 0, N - B)]
        u_new, L_new, acc = replace_batch(
            k_walk, live_u[start_ix], live_L[start_ix], live_u[survivors],
            L_star, scale)
        live_u = live_u.at[killed].set(u_new)
        live_L = live_L.at[killed].set(L_new)

        # Robbins-Monro on the in-region acceptance toward 0.5
        scale = scale * jnp.exp(0.5 * (acc - 0.5))
        scale = jnp.clip(scale, 1e-4, 10.0)

        logX_new = logX + round_shrink
        done_new = (logX_new + jnp.max(live_L)
                    < jnp.log(jnp.asarray(stop_frac, dtype)) + logZ_new)
        return (live_u, live_L, logX_new, logZ_new, h_new, r + 1,
                done_new, key, scale, dead_u, dead_L, dead_logw, acc)

    k_init, k_run = jax.random.split(key)
    live_u0 = jax.random.uniform(k_init, (N, d), dtype,
                                 minval=1e-7, maxval=1.0 - 1e-7)
    live_L0 = ll_batch(live_u0)

    state0 = (live_u0, live_L0, jnp.zeros((), dtype), neg_inf,
              jnp.zeros((), dtype), jnp.asarray(0, jnp.int32),
              jnp.asarray(False), k_run, jnp.asarray(0.3, dtype),
              jnp.zeros((T * B, d), dtype), jnp.full((T * B,), neg_inf, dtype),
              jnp.full((T * B,), neg_inf, dtype), jnp.zeros((), dtype))

    (live_u, live_L, logX, logZ, h, r, done, _k, scale,
     dead_u, dead_L, dead_logw, acc_last) = jax.jit(
        lambda s: lax.while_loop(cond, body, s))(state0)

    # final live-point contribution: each carries X/N of remaining mass
    log_w_live = live_L + logX - jnp.log(jnp.asarray(N, dtype))
    logZ_final = jnp.logaddexp(
        logZ, jax.scipy.special.logsumexp(log_w_live))
    dZ_frac = jnp.exp(jax.scipy.special.logsumexp(log_w_live) - logZ_final)
    wl_live = jax.nn.softmax(log_w_live)
    mean_lnL_live = jnp.sum(jnp.where(wl_live > 0, wl_live * live_L, 0.0))
    carried = jnp.where(jnp.isfinite(logZ),
                        jnp.exp(logZ - logZ_final) * (h + logZ), 0.0)
    h_final = (carried + dZ_frac * mean_lnL_live) - logZ_final

    n_rounds = int(r)
    n_dead = n_rounds * B
    u_all = jnp.concatenate([dead_u[:n_dead], live_u], axis=0)
    log_l = jnp.concatenate([dead_L[:n_dead], live_L], axis=0)
    log_w = jnp.concatenate([dead_logw[:n_dead], log_w_live], axis=0) \
        - logZ_final
    samples = pt(jnp.clip(u_all, 1e-7, 1 - 1e-7))

    return NestedResult(
        log_z=logZ_final,
        log_z_err=jnp.sqrt(jnp.maximum(h_final, 0.0)
                           / jnp.asarray(N, dtype)),
        h=h_final,
        samples=samples, log_w=log_w, log_l=log_l,
        n_like_evals=int(N + n_rounds * B * walks),
        n_rounds=n_rounds,
        accept_rate=acc_last,
        converged=bool(done),
    )
