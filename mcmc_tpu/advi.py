"""ADVI — automatic differentiation variational inference.

No reference analog — MCMCLib is sampling-only. This is the classic
fixed-form Gaussian VI of Kucukelbir et al. (2017, JMLR; Stan's
``variational`` mode): maximize the reparameterized Monte-Carlo ELBO

    ELBO(phi) = E_{z~N(0,I)}[ box_log_kernel(mu + L z) ] + entropy(q)

over an unconstrained-space Gaussian ``q`` — mean-field (diagonal, the
default) or full-rank (Cholesky). The entropy is closed-form
(``sum log sd + d/2 log 2*pi*e``), the expectation a ``n_mc`` per-step
sample average; bounded problems reuse the samplers' transform +
log-Jacobian stack so ``q`` lives exactly where the chains do.

Relative to the framework's other approximators: `map_laplace` matches
curvature AT the mode (one Hessian), `pathfinder` picks the best quadratic
along an optimization path (no Hessian, typical-set-seeking), and ADVI
*optimizes the Gaussian directly against the KL* — the most accurate of
the three when the posterior is close to Gaussian in the unconstrained
space, at the cost of a full stochastic optimization. The final ELBO is a
lower bound on ``log Z`` (tight exactly when q matches the posterior),
cross-checkable against evidence.py / nested.py estimates.

Accelerator-native design: the entire optimization is ONE jitted ``lax.scan`` of
Adam steps — each step draws its ``(n_mc, d)`` reparameterization batch
and evaluates the target vmapped; nothing leaves the device until the
ELBO trace returns. Full-rank parameterizes ``L`` as an unconstrained
strict lower triangle plus an exp-reparameterized diagonal, so the scan
state is a flat pytree with no constraint projections.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import bounds as bounds_mod
from mcmc_tpu.settings import AlgoSettings
from mcmc_tpu.samplers import common

__all__ = ["advi", "ADVIResult"]


@dataclasses.dataclass
class ADVIResult:
    """Fitted Gaussian variational approximation (unconstrained space).

    Attributes:
        mean_z: variational mean in unconstrained coordinates.
        mean: the same point mapped to constrained space.
        sd_z: marginal standard deviations (diag of ``L L^T``, sqrt).
        chol: the full Cholesky factor ``L`` (diagonal matrix when
            mean-field).
        elbo: final smoothed ELBO — a lower bound on ``log Z`` when
            ``log_kernel`` is a normalized joint.
        elbo_trace: per-step MC ELBO estimates (monitor convergence; a
            still-rising tail means raise ``n_steps``).
    """

    mean_z: Any
    mean: Any
    sd_z: Any
    chol: Any
    elbo: Any
    elbo_trace: Any
    unravel: Any = None   # pytree-input runs: unravel_draws(draw(...), .)
    _codes: Any = dataclasses.field(repr=False, default=None)
    _lb: Any = dataclasses.field(repr=False, default=None)
    _ub: Any = dataclasses.field(repr=False, default=None)
    _vals_bound: bool = dataclasses.field(repr=False, default=False)

    def draw(self, key, n: int):
        """``n`` draws from q, mapped to constrained space — posterior
        approximation or overdispersed-ish chain initialization."""
        z = jax.random.normal(key, (n, self.mean_z.shape[0]),
                              self.mean_z.dtype)
        x = self.mean_z + z @ self.chol.T
        if not self._vals_bound:
            return x
        return bounds_mod.inv_transform(x, self._codes, self._lb, self._ub)


def advi(initial_vals, log_kernel, settings=None, *, full_rank=False,
         n_steps=2000, n_mc=8, learning_rate=0.05, key=None,
         dtype=None) -> ADVIResult:
    """Fit a Gaussian variational approximation by reparameterized ELBO
    ascent (module docstring).

    ``full_rank=False`` (mean-field) learns per-coordinate scales only —
    fast, underestimates correlated-posterior variances; ``True`` learns
    the full Cholesky (d*(d+1)/2 parameters). ``n_mc`` reparameterization
    samples per step trade gradient variance for cost.
    """
    import optax
    if settings is None:
        settings = AlgoSettings()
    if not isinstance(settings, AlgoSettings):
        raise TypeError(f"settings must be AlgoSettings or None; got "
                        f"{type(settings).__name__}")
    if key is None:
        key = jax.random.PRNGKey(int(settings.rng_seed_value))
    from mcmc_tpu.pytree import coerce_model
    initial_vals, (log_kernel,), unravel = coerce_model(initial_vals,
                                                        log_kernel)

    prob = common.setup_problem(initial_vals, log_kernel, settings,
                                n_chains=1, dtype=dtype)
    box = prob.box_log_kernel
    d, dt = prob.n_vals, prob.dtype
    z0 = prob.first_draw[0]
    tril_ix = jnp.tril_indices(d, k=-1)

    def unpack(phi):
        """phi -> (mu, L) with L lower-triangular, exp-diagonal."""
        mu = phi["mu"]
        diag = jnp.exp(phi["log_diag"])
        if full_rank:
            L = jnp.zeros((d, d), dt).at[tril_ix].set(phi["off"]) \
                + jnp.diag(diag)
        else:
            L = jnp.diag(diag)
        return mu, L, diag

    def neg_elbo(phi, zs):
        mu, L, diag = unpack(phi)
        xs = mu + zs @ L.T
        # per-sample masking with safe-input substitution: ONE bad MC
        # sample (NaN/inf value or backward pass outside support) would
        # otherwise NaN the whole summed gradient and — after the
        # elementwise isfinite zeroing — silently no-op the entire step.
        # Masking only the OUTPUT is not enough (0 * NaN-cotangent is
        # still NaN through the where-vjp), so bad rows are replaced by
        # the variational mean, whose gradient path is cut and whose
        # backward pass is finite whenever mu is in support; the
        # elementwise gradient guard below remains the last resort.
        ok = jnp.isfinite(jax.vmap(box)(lax.stop_gradient(xs)))
        xs_safe = jnp.where(ok[:, None], xs,
                            lax.stop_gradient(mu)[None, :])
        lps = jnp.where(ok, jax.vmap(box)(xs_safe), 0.0)
        mean_lp = lps.sum() / jnp.maximum(ok.sum(), 1)
        # all-masked batch: the data term vanishes and only entropy pulls
        # (widening q until it finds support) — still finite, never NaN
        entropy = jnp.sum(jnp.log(diag)) \
            + 0.5 * d * (1.0 + jnp.log(2 * jnp.pi))
        return -(mean_lp + entropy)

    phi0 = {"mu": z0, "log_diag": jnp.full((d,), -1.0, dt)}
    if full_rank:
        phi0["off"] = jnp.zeros((d * (d - 1)) // 2, dt)
    T = int(n_steps)
    # decayed steps + a Polyak average over the final fifth kill the
    # O(lr) stationary jitter of constant-step stochastic ELBO ascent
    sched = optax.exponential_decay(learning_rate, T, 0.01)
    opt = optax.adam(sched)
    tail_start = (4 * T) // 5

    def step(carry, tk):
        phi, opt_state, acc, cnt = carry
        t, k = tk
        zs = jax.random.normal(k, (int(n_mc), d), dt)
        loss, g = jax.value_and_grad(neg_elbo)(phi, zs)
        g = jax.tree_util.tree_map(
            lambda v: jnp.where(jnp.isfinite(v), v, 0.0), g)
        upd, opt_state = opt.update(g, opt_state, phi)
        phi = optax.apply_updates(phi, upd)
        in_tail = t >= tail_start
        acc = jax.tree_util.tree_map(
            lambda a, p: jnp.where(in_tail, a + p, a), acc, phi)
        cnt = cnt + jnp.where(in_tail, 1, 0)
        return (phi, opt_state, acc, cnt), -loss

    keys = jax.random.split(key, T)
    acc0 = jax.tree_util.tree_map(jnp.zeros_like, phi0)
    (phi_last, _, acc, cnt), elbo_trace = jax.jit(
        lambda p, a, ks: lax.scan(
            step, (p, opt.init(p), a, jnp.asarray(0, jnp.int32)),
            (jnp.arange(T), ks)))(phi0, acc0, keys)
    phi = jax.tree_util.tree_map(
        lambda a: a / jnp.maximum(cnt, 1).astype(dt), acc)

    mu, L, diag = unpack(phi)
    sd_z = jnp.sqrt(jnp.sum(L * L, axis=1))
    mean = mu
    if prob.vals_bound:
        mean = bounds_mod.inv_transform(mu, prob.codes, prob.lower_bounds,
                                        prob.upper_bounds)
    tail = elbo_trace[-max(int(n_steps) // 20, 1):]
    return ADVIResult(
        mean_z=mu, mean=mean, sd_z=sd_z, chol=L,
        elbo=tail.mean(), elbo_trace=elbo_trace, unravel=unravel,
        _codes=prob.codes, _lb=prob.lower_bounds, _ub=prob.upper_bounds,
        _vals_bound=prob.vals_bound,
    )
