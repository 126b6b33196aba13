"""Pathfinder — L-BFGS-path variational initialization.

No reference analog — MCMCLib users hand-pick ``initial_vals`` (every
reference example hardcodes them, e.g. examples/eigen/nuts_normal.cpp).
This implements Pathfinder (Zhang, Carpenter, Gelman & Vehtari 2022, JMLR
23(306); Stan's default initializer): follow an L-BFGS optimization path
toward the posterior mode, wrap the quadratic (inverse-Hessian) Gaussian
approximation around *every* iterate, score each by a Monte-Carlo ELBO, and
draw from the best — typically an iterate in the *typical set*, before the
path collapses into the mode. Multi-path mode runs several independent
paths and Pareto-smoothed-importance-resamples the pooled draws. Compared
to :func:`mcmc_tpu.laplace.map_laplace` (mode + curvature at the mode),
Pathfinder targets the bulk of the posterior and costs only gradients — no
Hessian — so it scales to high dimension and is robust on non-Gaussian
geometry (funnels score low-ELBO at the mode and pick an earlier iterate).

Accelerator-native design (vs. Stan's sequential C++ loop):

- the L-BFGS path is one ``lax.scan`` of ``optax.lbfgs`` (zoom line
  search) carrying fixed-shape ``(J, d)`` ring buffers of curvature pairs
  and the diagonal-BFGS ``alpha`` estimate — all iterates' buffers are
  *stacked* on the way out;
- the ELBO phase then evaluates ALL iterates at once: a single vmap over
  the path builds each iterate's factored covariance
  ``Sigma = diag(alpha) + U M U^T`` (inverse-BFGS compact representation,
  Byrd-Nocedal-Schnabel 1994) via a batched thin-QR + ``(2J, 2J)`` eigh —
  ``d x 2J`` matrix products, no ``d x d`` factorization anywhere — and scores
  ``n_elbo_draws`` per iterate in one batched log-density pass;
- paths vmap over a leading axis (multi-path Pathfinder is embarrassingly
  parallel), and the PSIS resampling reuses the framework's own
  Pareto-smoothing (:func:`mcmc_tpu.model_compare._psis_smooth_one`) with
  a Gumbel top-k draw WITHOUT replacement (Stan's default ``psis_resample``).

Sampling/log-density use the factorization
``Sigma = sqrt(alpha) (I + Q C Q^T) sqrt(alpha)`` with ``A = diag(alpha)^-1/2
U = Q R_a`` (thin QR), ``C = R_a M R_a^T = V diag(lam) V^T``:
``x = mu + sqrt(alpha) * (z + W ((sqrt(1+lam)-1) * W^T z))``, ``W = Q V``,
``log|Sigma| = sum log alpha + sum log1p(lam)`` — exact draws and
log-densities in ``O(d J)`` per sample. PD (``1 + lam > 0``) is checked per
iterate; non-PD iterates are excluded from the ELBO argmax, as in the paper.

Bounded problems run entirely in unconstrained space on the box kernel
(prior + log-Jacobian), like the samplers; returned draws are
back-transformed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import bounds as bounds_mod
from mcmc_tpu.settings import AlgoSettings
from mcmc_tpu.samplers import common

__all__ = ["pathfinder", "PathfinderResult"]

_CURV_EPS = 1e-12       # curvature-pair acceptance s.y > eps*|s||y|
_PD_EPS = 1e-8          # eigenvalue floor for 1 + lam


@dataclasses.dataclass
class PathfinderResult:
    """Pathfinder output.

    Attributes:
        draws: ``(n_draws, n_vals)`` PSIS-resampled draws, constrained
            space — feed directly as overdispersed ``initial_vals`` (or a
            rough posterior approximation in their own right).
        log_p: box log-kernel at each draw (unconstrained-space density).
        log_q: the generating path-Gaussian's log-density at each draw.
        pareto_k: GPD shape of the pooled importance weights — k < 0.7
            means the resampled draws are a usable posterior
            approximation, larger means use them only as initialization.
        elbo: ``(n_paths,)`` best ELBO per path.
        best_iter: ``(n_paths,)`` index of the winning L-BFGS iterate.
        n_lbfgs_iters: iterations each path actually improved
            (diagnostic: paths hitting ``max_iters`` may want more).
    """

    draws: Any
    log_p: Any
    log_q: Any
    pareto_k: Any
    elbo: Any
    best_iter: Any
    n_lbfgs_iters: Any
    unravel: Any = None   # pytree-input runs: unravel_draws(draws, unravel)
    _draws_z: Any = dataclasses.field(repr=False, default=None)
    _codes: Any = dataclasses.field(repr=False, default=None)
    _lb: Any = dataclasses.field(repr=False, default=None)
    _ub: Any = dataclasses.field(repr=False, default=None)
    _vals_bound: bool = dataclasses.field(repr=False, default=False)

    def draw_init(self, key, n_chains: int):
        """``n_chains`` rows resampled (with replacement) from ``draws`` —
        chain initialization in constrained space."""
        ix = jax.random.randint(key, (n_chains,), 0, self.draws.shape[0])
        return self.draws[ix]

    @property
    def center(self):
        """Posterior-bulk center: the unconstrained draw mean mapped back
        to constrained space (the Pathfinder analog of
        :attr:`LaplaceResult.mode` for the population samplers)."""
        zm = self._draws_z.mean(axis=0)
        if not self._vals_bound:
            return zm
        return bounds_mod.inv_transform(zm, self._codes, self._lb, self._ub)

    def init_box(self, scale: float = 2.0):
        """Spread-matched initial box ``(lb, ub)`` in constrained space,
        built as ``mean ± scale·sd`` of the unconstrained draws and mapped
        back — feed to the population samplers' ``initial_lb``/``initial_ub``
        (same contract as :meth:`LaplaceResult.init_box`)."""
        zm = self._draws_z.mean(axis=0)
        sd = self._draws_z.std(axis=0)
        lo, hi = zm - scale * sd, zm + scale * sd
        if not self._vals_bound:
            return lo, hi
        inv = lambda v: bounds_mod.inv_transform(v, self._codes, self._lb,
                                                 self._ub)
        return inv(lo), inv(hi)

    @property
    def spread_z(self):
        """Per-dimension standard deviation of the unconstrained draws —
        the walker-ball spread for the stretch ensemble."""
        return self._draws_z.std(axis=0)


def _diag_bfgs_update(alpha, s, y, ok):
    """Elementwise diagonal-BFGS update of the inverse-Hessian diagonal
    (Zhang et al. 2022, eq. 10): with b = 1/alpha,
    ``b' = b + y^2/(y.s) - (b s)^2 / (s.(b s))``; Cauchy-Schwarz keeps
    b' >= y^2/(y.s) > 0."""
    b = 1.0 / alpha
    sy = s @ y
    bs = b * s
    b_new = b + y * y / sy - bs * bs / (s @ bs)
    b_new = jnp.maximum(b_new, 1e-12)
    return jnp.where(ok, 1.0 / b_new, alpha)


def _lbfgs_path(box, x0, max_iters, memory):
    """Scan optax.lbfgs from ``x0``, carrying (J, d) ring buffers of
    curvature pairs and the diagonal alpha. Returns per-iterate stacks:
    theta, g (grad of box = grad log p), S, Y, alpha, pair_mask, ok."""
    import optax
    d = x0.shape[0]
    dt = x0.dtype
    J = int(memory)
    neg = lambda z: -box(z)
    vg = jax.value_and_grad(neg)
    opt = optax.lbfgs(memory_size=J)

    def step(carry, _):
        x, opt_state, val, grad, S, Y, alpha, pmask = carry
        upd, opt_state = opt.update(grad, opt_state, x, value=val,
                                    grad=grad, value_fn=neg)
        x_new = optax.apply_updates(x, upd)
        val_new, grad_new = vg(x_new)
        s = x_new - x
        y = grad_new - grad          # gradients of NEGATIVE log p
        finite = jnp.isfinite(val_new) & jnp.all(jnp.isfinite(x_new)) \
            & jnp.all(jnp.isfinite(grad_new))
        curv_ok = (s @ y) > _CURV_EPS * jnp.linalg.norm(s) \
            * jnp.linalg.norm(y)
        ok = finite & curv_ok
        # shift-in the accepted pair (oldest drops off row 0)
        S = jnp.where(ok, jnp.concatenate([S[1:], s[None]], 0), S)
        Y = jnp.where(ok, jnp.concatenate([Y[1:], y[None]], 0), Y)
        pmask = jnp.where(ok,
                          jnp.concatenate([pmask[1:],
                                           jnp.ones((1,), bool)], 0), pmask)
        alpha = _diag_bfgs_update(alpha, s, y, ok)
        # a rejected step must not poison the carried point
        x_keep = jnp.where(finite, x_new, x)
        val_keep = jnp.where(finite, val_new, val)
        grad_keep = jnp.where(finite, grad_new, grad)
        carry = (x_keep, opt_state, val_keep, grad_keep, S, Y, alpha, pmask)
        out = (x_keep, -grad_keep, S, Y, alpha, pmask, ok)
        return carry, out

    val0, grad0 = vg(x0)
    carry0 = (x0, opt.init(x0), val0, grad0,
              jnp.zeros((J, d), dt), jnp.zeros((J, d), dt),
              jnp.ones((d,), dt), jnp.zeros((J,), bool))
    _, outs = lax.scan(step, carry0, None, length=int(max_iters))
    return outs   # each (T, ...)


def _gauss_pieces(S, Y, alpha, pmask):
    """One iterate's Gaussian factorization from its (J, d) buffers.

    Returns ``(W, lam, logdet, ok)`` with ``W (d, K)`` orthonormal columns,
    ``K = min(d, 2J)``: ``Sigma = sqrt(a)(I + W diag(lam) W^T) sqrt(a)``.
    Masked (absent) pairs have zero rows in S/Y, so their contribution
    vanishes; R gets unit diagonal there to stay invertible."""
    J, d = S.shape
    dt = S.dtype
    Sm = S.T                     # (d, J) columns = s_j
    Ym = Y.T
    STY = Sm.T @ Ym              # (J, J)
    R = jnp.triu(STY)
    R = R + jnp.diag(jnp.where(pmask, 0.0, 1.0).astype(dt))
    D = jnp.diag(STY) * pmask    # (J,)
    E = Ym.T @ (alpha[:, None] * Ym)
    G = jax.scipy.linalg.solve_triangular(R, jnp.eye(J, dtype=dt),
                                          lower=False)        # R^{-1}
    mid = G.T @ (jnp.diag(D) + E) @ G
    M2 = jnp.block([[mid, -G.T], [-G, jnp.zeros((J, J), dt)]])  # (2J, 2J)
    U = jnp.concatenate([Sm, alpha[:, None] * Ym], axis=1)      # (d, 2J)
    Ahat = U / jnp.sqrt(alpha)[:, None]
    Q, Ra = jnp.linalg.qr(Ahat, mode="reduced")     # (d,K), (K,2J)
    C = Ra @ M2 @ Ra.T                              # (K, K) symmetric
    C = 0.5 * (C + C.T)
    lam, V = jnp.linalg.eigh(C)
    W = Q @ V                                        # (d, K)
    ok = jnp.all(jnp.isfinite(lam)) & jnp.all(jnp.isfinite(W)) \
        & jnp.all(1.0 + lam > _PD_EPS) & jnp.all(jnp.isfinite(alpha)) \
        & jnp.all(alpha > 0)
    lam = jnp.where(ok, lam, jnp.zeros_like(lam))
    W = jnp.where(ok, W, jnp.zeros_like(W))
    logdet = jnp.sum(jnp.log(alpha)) + jnp.sum(jnp.log1p(lam))
    return W, lam, logdet, ok


def _sigma_mv(v, alpha, S, Y, pmask):
    """Sigma @ v through the compact representation (used for the Newton
    shift mu = theta + Sigma grad); same masking as :func:`_gauss_pieces`."""
    J, d = S.shape
    dt = S.dtype
    Sm, Ym = S.T, Y.T
    STY = Sm.T @ Ym
    R = jnp.triu(STY) + jnp.diag(jnp.where(pmask, 0.0, 1.0).astype(dt))
    D = jnp.diag(STY) * pmask
    E = Ym.T @ (alpha[:, None] * Ym)
    G = jax.scipy.linalg.solve_triangular(R, jnp.eye(J, dtype=dt),
                                          lower=False)
    mid = G.T @ (jnp.diag(D) + E) @ G
    u1 = Sm.T @ v                      # (J,)
    u2 = Ym.T @ (alpha * v)
    t1 = mid @ u1 - G.T @ u2
    t2 = -G @ u1
    return alpha * v + Sm @ t1 + (alpha[:, None] * Ym) @ t2


def _sample_gauss(key, mu, alpha, W, lam, n):
    """n draws + their log-q from N(mu, Sigma) in factored form."""
    d = mu.shape[0]
    dt = mu.dtype
    z = jax.random.normal(key, (n, d), dt)
    scale = jnp.sqrt(1.0 + lam) - 1.0                 # (K,)
    x = mu + jnp.sqrt(alpha) * (z + (z @ W * scale) @ W.T)
    logdet = jnp.sum(jnp.log(alpha)) + jnp.sum(jnp.log1p(lam))
    logq = -0.5 * d * jnp.log(2 * jnp.pi).astype(dt) - 0.5 * logdet \
        - 0.5 * jnp.sum(z * z, axis=1)
    return x, logq


def pathfinder(initial_vals, log_kernel, settings=None, *, n_paths=8,
               n_draws=1000, n_draws_per_path=None, max_iters=60, memory=6,
               n_elbo_draws=25, jitter_scale=2.0, key=None,
               dtype=None) -> PathfinderResult:
    """Multi-path Pathfinder (module docstring).

    ``initial_vals`` seeds path 0; the other ``n_paths - 1`` paths start
    from Gaussian ``jitter_scale``-sized perturbations in unconstrained
    space. ``memory`` is the L-BFGS history J (covariance rank <= 2J).
    Draws: each path contributes ``n_draws_per_path`` (default
    ``ceil(2 * n_draws / n_paths)``) from its best-ELBO iterate; the pool
    is Pareto-smoothed and resampled to ``n_draws`` without replacement
    (Gumbel top-k).
    """
    from mcmc_tpu.model_compare import _psis_smooth_one

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
    n_paths = int(n_paths)
    if n_paths < 1:
        raise ValueError(f"n_paths must be >= 1, got {n_paths}")
    if n_draws_per_path is None:
        n_draws_per_path = max(-(-2 * int(n_draws) // n_paths), 25)
    pool = n_paths * int(n_draws_per_path)
    if pool < int(n_draws):
        raise ValueError(
            f"resampling pool {pool} (= n_paths * n_draws_per_path) is "
            f"smaller than n_draws={n_draws}")

    prob = common.setup_problem(initial_vals, log_kernel, settings,
                                n_chains=n_paths, dtype=dtype)
    box = prob.box_log_kernel
    d, dt = prob.n_vals, prob.dtype

    k_jit, k_run = jax.random.split(key)
    z0 = prob.first_draw
    jit = jax.random.normal(k_jit, z0.shape, dt) * jnp.asarray(
        jitter_scale, dt)
    z0 = z0 + jit.at[0].set(0.0)

    def one_path(key, x0):
        theta, g, S, Y, alpha, pmask, ok_it = _lbfgs_path(
            box, x0, max_iters, memory)
        T = theta.shape[0]

        W, lam, _logdet, ok_g = jax.vmap(_gauss_pieces)(S, Y, alpha, pmask)
        mu = theta + jax.vmap(_sigma_mv)(g, alpha, S, Y, pmask)
        mu_ok = jnp.all(jnp.isfinite(mu), axis=1)
        valid = ok_it & ok_g & mu_ok

        k_elbo, k_final = jax.random.split(key)
        elbo_keys = jax.random.split(k_elbo, T)
        xs, logqs = jax.vmap(
            lambda k, m, a, w, l: _sample_gauss(k, m, a, w, l,
                                                int(n_elbo_draws))
        )(elbo_keys, mu, alpha, W, lam)                 # (T, M, d), (T, M)
        logps = jax.vmap(jax.vmap(box))(xs)
        logps = jnp.where(jnp.isfinite(logps), logps, -jnp.inf)
        elbo = jnp.mean(logps - logqs, axis=1)
        elbo = jnp.where(valid & jnp.isfinite(elbo), elbo, -jnp.inf)

        best = jnp.argmax(elbo)
        x_fin, logq_fin = _sample_gauss(
            k_final, mu[best], alpha[best], W[best], lam[best],
            int(n_draws_per_path))
        logp_fin = jax.vmap(box)(x_fin)
        logp_fin = jnp.where(jnp.isfinite(logp_fin), logp_fin, -jnp.inf)
        return (x_fin, logp_fin, logq_fin, elbo[best], best,
                ok_it.sum())

    keys = jax.random.split(k_run, n_paths)
    xs, logp, logq, elbos, bests, n_ok = jax.jit(jax.vmap(one_path))(keys, z0)

    # pooled PSIS resampling without replacement (Gumbel top-k)
    lw = (logp - logq).reshape(-1)
    S_pool = lw.shape[0]
    M_tail = int(min(0.2 * S_pool, 3.0 * math.sqrt(S_pool)))
    if M_tail >= 5:
        lw_smooth, khat = _psis_smooth_one(lw, M_tail)
    else:
        lw_smooth = lw - jax.scipy.special.logsumexp(lw)
        khat = jnp.asarray(jnp.inf, dt)
    from mcmc_tpu.stats import gumbel_topk
    k_gum, = jax.random.split(keys[-1], 1)
    take = gumbel_topk(k_gum, lw_smooth, int(n_draws))

    draws_z = xs.reshape(-1, d)[take]
    draws = draws_z
    if prob.vals_bound:
        draws = bounds_mod.inv_transform(draws_z, prob.codes,
                                         prob.lower_bounds, prob.upper_bounds)
    return PathfinderResult(
        draws=draws, log_p=lw[take] + logq.reshape(-1)[take],
        log_q=logq.reshape(-1)[take], pareto_k=khat,
        elbo=elbos, best_iter=bests, n_lbfgs_iters=n_ok,
        unravel=unravel,
        _draws_z=draws_z,
        _codes=prob.codes, _lb=prob.lower_bounds, _ub=prob.upper_bounds,
        _vals_bound=prob.vals_bound,
    )
