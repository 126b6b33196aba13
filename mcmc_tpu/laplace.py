"""MAP + Laplace approximation — posterior-mode initialization.

Beyond-reference utility: MCMCLib ships no optimizer, so its users hand-pick
``initial_vals`` (every reference example hardcodes them, e.g.
examples/eigen/rwmh_normal_mean.cpp). Here the framework finds the posterior
mode itself and wraps a Gaussian (Laplace) approximation around it, giving

- overdispersed chain initialization (``LaplaceResult.draw_init``) that
  starts every chain in the typical set instead of a user guess, and
- a curvature-matched covariance usable as a preconditioner seed.

Accelerator-first design: the whole MAP search is ONE jitted ``lax.scan`` of Adam
steps with the restart axis vmapped — ``n_restarts`` optimizations run as a
single batched compute graph (no Python loop, no host round-trips). The
Hessian comes from ``jax.hessian`` (forward-over-reverse) at the best mode;
a symmetric eigenvalue clamp makes the covariance PD even at saddle-ish
stationary points. Bounded problems optimize in unconstrained coordinates
via the same transform/log-Jacobian stack the samplers use
(reference misc/transform_vals.hpp semantics), so the Laplace covariance
lives in the sampler's own working space.

Bounded-mode semantics: the objective is the *box* log-kernel — user
log-kernel plus log-Jacobian — i.e. the exact density the chains sample in
unconstrained coordinates. Its maximizer mapped back through
``inv_transform`` therefore differs from the constrained-space MAP by the
Jacobian term (e.g. a Gamma(k, r) posterior behind ``z = log x`` yields
``mode = k/r``, not ``(k-1)/r``). That is deliberate: the Gaussian must
match where the unconstrained-space mass sits, which is what
initialization and preconditioning consume.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from mcmc_tpu import bounds as bounds_mod
from mcmc_tpu.settings import AlgoSettings
from mcmc_tpu.samplers import common

__all__ = ["map_laplace", "LaplaceResult"]


@dataclasses.dataclass
class LaplaceResult:
    """Laplace approximation around the MAP.

    Attributes:
        mode: MAP point in constrained (user) space, ``(n_vals,)``.
        mode_z: the same point in unconstrained coordinates (equal to
            ``mode`` when unbounded).
        cov: Laplace covariance in unconstrained space — the inverse of the
            negative box-log-kernel Hessian, eigenvalue-clamped to PD.
        cov_sqrt: a matrix square root ``S`` with ``S @ S.T == cov``.
        log_post: box log-kernel value at the mode (includes the
            log-Jacobian term when bounded).
        grad_norm: gradient norm at the mode — convergence indicator.
        restart_log_posts: best box log-kernel per restart (diagnostic for
            multimodality: spread here means restarts found different modes).
    """

    mode: Any
    mode_z: Any
    cov: Any
    cov_sqrt: Any
    log_post: Any
    grad_norm: Any
    restart_log_posts: Any
    unravel: Any = None   # pytree-input runs: unravel flat mode/draws
    _codes: Any = dataclasses.field(repr=False, default=None)
    _lb: Any = dataclasses.field(repr=False, default=None)
    _ub: Any = dataclasses.field(repr=False, default=None)
    _vals_bound: bool = dataclasses.field(repr=False, default=False)

    def draw_init(self, key, n_chains: int, scale: float = 2.0):
        """Overdispersed initial positions: ``n_chains`` draws from the
        Laplace Gaussian widened by ``scale``, mapped back to constrained
        space — feed directly as a sampler's ``initial_vals``."""
        xi = jax.random.normal(key, (n_chains, self.mode_z.shape[0]),
                               self.mode_z.dtype)
        z = self.mode_z + scale * (xi @ self.cov_sqrt.T)
        if not self._vals_bound:
            return z
        return jax.vmap(
            lambda v: bounds_mod.inv_transform(v, self._codes, self._lb, self._ub)
        )(z)

    @property
    def log_evidence(self):
        """Laplace approximation to the log marginal likelihood:
        ``log p(mode) + d/2·log 2π + ½·log|Σ|`` (the Gaussian integral of
        the quadratic expansion around the mode, in unconstrained space —
        exact when the box posterior is Gaussian). Requires ``log_kernel``
        to be the *normalized* joint ``log prior + log lik``; cross-check
        against :func:`mcmc_tpu.evidence.thermo_evidence` and SMC's
        ``log_z`` (see mcmc_tpu/evidence.py)."""
        d = self.mode_z.shape[0]
        _, logdet = jnp.linalg.slogdet(self.cov)
        return self.log_post + 0.5 * d * jnp.log(2.0 * jnp.pi) + 0.5 * logdet

    def init_box(self, scale: float = 2.0):
        """Curvature-matched initial box ``(lb, ub)`` in *constrained*
        space: ``mode_z ± scale * sd`` built in unconstrained coordinates
        (where ``cov`` lives) and mapped back — feed to the population
        samplers' ``initial_lb``/``initial_ub``. Building the box in
        constrained space from the unconstrained sd would mix spaces and
        collapse (or explode) the box for bounded parameters."""
        sd = jnp.sqrt(jnp.diagonal(self.cov))
        lo_z = self.mode_z - scale * sd
        hi_z = self.mode_z + scale * sd
        if not self._vals_bound:
            return lo_z, hi_z
        inv = lambda v: bounds_mod.inv_transform(v, self._codes, self._lb,
                                                 self._ub)
        return inv(lo_z), inv(hi_z)


def map_laplace(initial_vals, log_kernel, settings=None, *, n_steps=500,
                learning_rate=0.05, n_restarts=4, restart_scale=1.0,
                key=None, optimizer=None, dtype=None) -> LaplaceResult:
    """Find the posterior mode and its Laplace approximation.

    ``log_kernel(params) -> scalar`` is the same pure function the samplers
    take; ``settings`` is an :class:`AlgoSettings` (only its
    ``vals_bound`` / ``lower_bounds`` / ``upper_bounds`` fields are read) or
    ``None``. ``n_restarts`` batched Adam runs start from ``initial_vals``
    plus ``restart_scale``-sized Gaussian jitter in unconstrained space
    (restart 0 is unjittered); the best-objective iterate ever visited wins,
    so a final-step oscillation cannot lose the mode. ``optimizer`` accepts
    any optax ``GradientTransformation`` to replace the default Adam.
    """
    # optax is only needed here; importing lazily keeps the top-level
    # `import mcmc_tpu` free of the dependency (it is not a declared
    # install requirement — only the default optimizer uses it).
    import optax
    if settings is None:
        settings = AlgoSettings()
    if not isinstance(settings, AlgoSettings):
        raise TypeError(
            f"settings must be AlgoSettings or None; got "
            f"{type(settings).__name__}")
    if key is None:
        key = jax.random.PRNGKey(int(settings.rng_seed_value))
    from mcmc_tpu.pytree import coerce_model
    initial_vals, (log_kernel,), unravel = coerce_model(initial_vals,
                                                        log_kernel)
    n_restarts = int(n_restarts)
    if n_restarts < 1:
        raise ValueError(f"n_restarts must be >= 1, got {n_restarts}")

    prob = common.setup_problem(initial_vals, log_kernel, settings,
                                n_chains=n_restarts, dtype=dtype)
    box = prob.box_log_kernel
    opt = optimizer if optimizer is not None else optax.adam(learning_rate)

    z0 = prob.first_draw                                  # (n_restarts, d)
    jitter = jax.random.normal(key, z0.shape, z0.dtype) * restart_scale
    jitter = jitter.at[0].set(0.0)
    z0 = z0 + jitter

    neg = lambda z: -box(z)

    def run_one(z_init):
        opt_state = opt.init(z_init)
        f0 = neg(z_init)

        def step(carry, _):
            z, opt_state, best_z, best_f = carry
            f, g = jax.value_and_grad(neg)(z)
            # a non-finite iterate (overshoot) must not poison best-so-far
            better = jnp.isfinite(f) & (f < best_f)
            best_z = jnp.where(better, z, best_z)
            best_f = jnp.where(better, f, best_f)
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            updates, opt_state = opt.update(g, opt_state, z)
            z = optax.apply_updates(z, updates)
            return (z, opt_state, best_z, best_f), None

        best0 = jnp.where(jnp.isfinite(f0), f0, jnp.inf)
        (zf, _, best_z, best_f), _ = jax.lax.scan(
            step, (z_init, opt_state, z_init, best0), None, length=n_steps)
        ff = neg(zf)
        final_better = jnp.isfinite(ff) & (ff < best_f)
        best_z = jnp.where(final_better, zf, best_z)
        best_f = jnp.where(final_better, ff, best_f)
        return best_z, best_f

    @jax.jit
    def solve(z0):
        best_z, best_f = jax.vmap(run_one)(z0)
        ix = jnp.argmin(best_f)
        z_star = best_z[ix]
        hess = -jax.hessian(box)(z_star)
        hess = 0.5 * (hess + hess.T)
        eigval, eigvec = jnp.linalg.eigh(hess)
        # Directions with non-positive (or numerically zero) curvature are
        # not identified by the quadratic approximation (saddle/flat/ridge).
        # Give them the TIGHTEST direction's variance rather than a tiny
        # eigenvalue floor: 1/(1e-8*max) would inflate the covariance ~1e8x
        # and draw_init would launch chains astronomically far from the
        # mode (saturating bounds to +/-inf). Conservative-small keeps
        # chains near the mode; restart_log_posts/grad_norm still expose
        # the degeneracy to the caller.
        max_abs = jnp.maximum(jnp.max(jnp.abs(eigval)), 1.0)
        degenerate = eigval <= max_abs * 1e-8
        eigval = jnp.where(degenerate, max_abs, eigval)
        cov = (eigvec / eigval) @ eigvec.T
        cov_sqrt = eigvec / jnp.sqrt(eigval)
        grad_norm = jnp.linalg.norm(jax.grad(box)(z_star))
        return z_star, -best_f, cov, cov_sqrt, grad_norm

    z_star, log_posts, cov, cov_sqrt, grad_norm = solve(z0)
    mode = z_star
    if prob.vals_bound:
        mode = bounds_mod.inv_transform(z_star, prob.codes,
                                        prob.lower_bounds, prob.upper_bounds)
    return LaplaceResult(
        mode=mode, mode_z=z_star, cov=cov, cov_sqrt=cov_sqrt,
        log_post=jnp.max(log_posts), grad_norm=grad_norm,
        restart_log_posts=log_posts, unravel=unravel,
        _codes=prob.codes, _lb=prob.lower_bounds, _ub=prob.upper_bounds,
        _vals_bound=prob.vals_bound,
    )
