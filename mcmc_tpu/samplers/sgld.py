"""Stochastic-gradient MCMC: SGLD (Welling & Teh 2011) and SGHMC
(Chen, Fox & Guestrin 2014).

Beyond-reference samplers: the minibatch members of the gradient family,
for tall datasets where even one full log-likelihood gradient per draw
(MALA/HMC/NUTS) is too expensive. No reference analog — MCMCLib's samplers
all consume a full-data ``log_kernel`` callback; SG-MCMC is the
accelerator-native answer to the same scaling axis its OpenMP threads
cannot touch (SURVEY.md §2d "tall data").

Update rule (one draw)::

    g_t  = grad log_prior(x_t) + (N / B) * grad log_lik(x_t, minibatch_t)
    x_+  = x_t + (h_t / 2) * M g_t + sqrt(h_t) * chol(M) xi,  xi ~ N(0, I)

with ``h_t = step_size * (decay_b / (decay_b + t)) ** decay_gamma`` (the
Welling-Teh polynomial schedule; ``decay_gamma = 0`` keeps it constant).
There is NO Metropolis correction: with constant ``h`` the chain targets a
perturbed posterior with O(h) bias (tested against the exact closed form
of the unadjusted-Langevin Gaussian stationary variance), vanishing as
``h -> 0`` or under a decaying schedule. Minibatches are drawn uniformly
WITH replacement each draw, per chain (O(B) index generation; the gather
batches on the accelerator).

Accelerator-native design: the minibatch gather + gradient is one fused XLA
program per draw, vmapped over chains, scanned over draws; composes with
``mesh=`` chain sharding like every other sampler. In the default
``minibatch="per-chain"`` mode every chain draws its own minibatch, so
cross-chain gradient noise is independent; ``minibatch="shared"`` (the
throughput mode) shares one minibatch — and hence gradient noise —
across the chain batch, trading a little cross-chain diagnostic power
for a ~250x faster gather (see :func:`sgld`).

Box constraints run through the same transform stack as the full-gradient
samplers, with the likelihood-only scaling applied *after* the chain
rule: the exact ``grad [log_prior(g(z)) + log|J(z)|]`` plus
``(N/B) grad log_lik(g(z), batch)`` — both via ``jax.grad`` on the
unconstrained coordinates.

Failure semantics: a non-finite proposed position (exploding gradient,
too-large step) is rejected in place of crashing — the chain stays put
and the draw's ``accepted`` info is False, so ``accept_rate < 1`` is the
numerical-health signal (there is no MH accept to report otherwise; a
healthy run has ``accept_rate == 1``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_tpu import bounds as bounds_mod
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import SGLDSettings, SGHMCSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["sgld", "sghmc", "SGLDState", "SGHMCState",
           "build_sgld_kernel", "build_sghmc_kernel"]


def _validate_data(data, batch_size):
    """Coerce + validate a minibatch data pytree; returns (data, n_data)."""
    data = jax.tree_util.tree_map(jnp.asarray, data)
    leaves = jax.tree_util.tree_leaves(data)
    if not leaves:
        raise ValueError("data must contain at least one array")
    for a in leaves:
        if a.ndim == 0:
            raise ValueError(
                "every data leaf needs a leading observation axis (rank-0 "
                "leaf found); close the log_lik over scalar hyperparameters "
                "instead of putting them in data")
    n_data = leaves[0].shape[0]
    for a in leaves[1:]:
        if a.shape[0] != n_data:
            raise ValueError(
                f"all data leaves must share the leading observation axis; "
                f"got {a.shape[0]} vs {n_data}")
    if batch_size > n_data:
        raise ValueError(f"batch_size {batch_size} exceeds the dataset "
                         f"size {n_data}")
    return data, n_data


def _make_grad_parts(prob, log_lik):
    """(grad of prior+Jacobian in z, grad of likelihood in z) — the
    likelihood part is scaled by N/B AFTER the chain rule by callers."""
    if prob.vals_bound:
        def lik_z(z, batch):
            x = bounds_mod.inv_transform(z, prob.codes, prob.lower_bounds,
                                         prob.upper_bounds)
            return log_lik(x, batch)
    else:
        lik_z = log_lik
    return jax.grad(prob.box_log_kernel), jax.grad(lik_z)


class SGLDState(NamedTuple):
    position: jax.Array   # unconstrained coordinates
    v: jax.Array          # RMSprop accumulator ((1,) when not adapting)
    draw_ind: jax.Array   # drives the step-size schedule


def build_sgld_kernel(prob: common.Problem, log_lik, data, n_data,
                      precond: common.SPD, s: SGLDSettings,
                      rmsprop=False):
    """Returns ``(init, step, batched_step)``; ``step`` is the pure
    single-chain transition ``(key, state) -> (state, info)`` and
    ``batched_step`` the shared-minibatch chain-batch transition
    ``(keys, states) -> (states, infos)``.

    ``rmsprop=True`` enables pSGLD (Li, Chen, Carlson & Carin 2016): the
    diagonal preconditioner ``G = 1 / (lambda + sqrt(V))`` with
    ``V <- alpha V + (1 - alpha) gbar**2`` where ``gbar = g / N`` is the
    per-datum average stochastic gradient; the update becomes
    ``x += (h/2) G g + N(0, h G)``. The Gamma(theta) curvature term of
    the paper's eq. (4) is omitted, as in the paper's own experiments and
    standard implementations — it is O((1-alpha)) and vanishes as the
    accumulator equilibrates."""
    dt = prob.dtype
    B = int(s.batch_size)
    N = int(n_data)
    scale = jnp.asarray(N / B, dt)
    h0 = jnp.asarray(s.step_size, dt)
    gamma = float(s.decay_gamma)
    b = jnp.asarray(s.decay_b, dt)
    alpha = jnp.asarray(s.rmsprop_alpha, dt)
    lam = jnp.asarray(s.rmsprop_lambda, dt)

    grad_prior, grad_lik = _make_grad_parts(prob, log_lik)

    def init(position):
        v0 = jnp.zeros((prob.n_vals,), dt) if rmsprop else jnp.ones((1,), dt)
        return SGLDState(position=position, v=v0,
                         draw_ind=jnp.asarray(0, jnp.int32))

    def _schedule(draw_ind):
        t = draw_ind.astype(dt)
        return h0 * (b / (b + t)) ** gamma if gamma else h0

    def _update(k_noise, state: SGLDState, batch, h):
        """Langevin update given an already-gathered minibatch."""
        g = grad_prior(state.position) + scale * grad_lik(state.position,
                                                          batch)
        noise = jax.random.normal(k_noise, (prob.n_vals,), dt)
        if rmsprop:
            gbar = g / N
            v = alpha * state.v + (1.0 - alpha) * gbar * gbar
            G = 1.0 / (lam + jnp.sqrt(v))
            prop = state.position + 0.5 * h * G * g \
                + jnp.sqrt(h * G) * noise
        else:
            v = state.v
            prop = state.position + 0.5 * h * precond.mv(g) \
                + jnp.sqrt(h) * precond.sqrt_mv(noise)
        # the accumulator must pass the guard too: a finite-but-huge
        # gradient squares to inf in V, which makes G = 0 — a silently
        # FROZEN coordinate (no drift, no noise) on an otherwise finite
        # draw; reject such draws so V (and the position) stay intact
        ok = jnp.all(jnp.isfinite(prop)) & jnp.all(jnp.isfinite(v))
        new = jnp.where(ok, prop, state.position)
        v = jnp.where(ok, v, state.v)
        return (SGLDState(position=new, v=v,
                          draw_ind=state.draw_ind + 1),
                {"accepted": ok})

    def step(key, state: SGLDState):
        k_idx, k_noise = jax.random.split(key)
        idx = jax.random.randint(k_idx, (B,), 0, N)
        batch = jax.tree_util.tree_map(lambda a: a[idx], data)
        return _update(k_noise, state, batch, _schedule(state.draw_ind))

    def batched_step(keys, states: SGLDState):
        """Shared-minibatch chain-batch transition: ONE gather per draw
        for the whole batch, so the minibatch read is a contiguous slice
        feeding one matrix product instead of a per-chain random-row
        gather. Chain 0's per-draw key is split
        into disjoint (batch, noise) streams, every other chain
        contributes only its noise stream; chains share gradient noise
        but keep independent injected noise."""
        pairs = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
        idx = jax.random.randint(pairs[0, 0], (B,), 0, N)
        batch = jax.tree_util.tree_map(lambda a: a[idx], data)
        h = _schedule(states.draw_ind[0])

        def one(k_noise, st):
            return _update(k_noise, st, batch, h)

        return jax.vmap(one, axis_name=common.CHAIN_AXIS_NAME)(
            pairs[:, 1], states)

    return init, step, batched_step


def sgld(initial_vals, log_prior, log_lik, data, settings=None, *,
         n_chains=None, key=None, mesh=None, checkpoint_dir=None,
         checkpoint_every=500, dtype=None, thin=1, adapt_precond=False,
         minibatch="per-chain", return_resume=False) -> SamplerResult:
    """Run SGLD. ``log_prior(params) -> scalar`` and
    ``log_lik(params, batch) -> scalar`` (the SUM of the minibatch's
    log-likelihood terms) are pure JAX functions; ``data`` is any pytree
    whose leaves share a leading observation axis — each draw gathers a
    uniform-with-replacement minibatch of ``settings.batch_size`` rows.

    ``minibatch`` picks the gather strategy:

    - ``"per-chain"`` (default): every chain draws its own minibatch —
      fully independent chains, but the (chains, B) random-row gather is
      the per-draw bottleneck;
    - ``"shared"``: ONE minibatch per draw for the whole chain batch —
      the gather collapses to a (B, ...) slice feeding one matrix product
      (speed on the GPU not measured). Chains share gradient noise (slightly correlated chains;
      cross-chain diagnostics like R-hat lose a little power) but keep
      independent injected Langevin noise — each chain still targets the
      same distribution. The choice for throughput runs.

    ``adapt_precond=True`` (or ``"rmsprop"``) runs **pSGLD** (Li et al.
    2016): a per-dimension RMSprop preconditioner
    ``G = 1/(rmsprop_lambda + sqrt(V))`` learned online from the
    per-datum average gradient, equilibrating step sizes across badly
    scaled dimensions — incompatible with a fixed ``precond_mat``.

    All the usual driver options apply (``n_chains``/``mesh``/
    ``checkpoint_dir``/``thin``/``return_resume``); ``accept_rate`` is the
    fraction of draws whose update stayed finite (1.0 = healthy; there is
    no Metropolis accept). Box constraints via the umbrella settings'
    ``vals_bound``/bounds, same transform stack as MALA/HMC/NUTS.
    """
    algo, s = resolve_settings(settings, "sgld_settings", SGLDSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if not callable(log_lik):
        raise TypeError("log_lik must be callable: log_lik(params, batch)")

    data, n_data = _validate_data(data, s.batch_size)

    rmsprop = {True: "rmsprop"}.get(adapt_precond, adapt_precond)
    if rmsprop not in (False, "rmsprop"):
        raise ValueError(f"adapt_precond must be False/True/'rmsprop', "
                         f"got {adapt_precond!r}")
    if rmsprop and s.precond_mat is not None:
        raise ValueError("adapt_precond is incompatible with a user "
                         "precond_mat — the preconditioner is learned")

    if minibatch not in ("per-chain", "shared"):
        raise ValueError(f"minibatch must be 'per-chain' or 'shared', "
                         f"got {minibatch!r}")

    prob = common.setup_problem(initial_vals, log_prior, algo, n_chains,
                                dtype)
    precond = common.make_spd(s.precond_mat, prob.n_vals, prob.dtype)
    kernels = build_sgld_kernel(
        prob, log_lik, data, n_data, precond, s, rmsprop=bool(rmsprop))
    return _drive_sg_mcmc(kernels, prob, minibatch == "shared", key,
                          s.n_burnin_draws, s.n_keep_draws, mesh,
                          checkpoint_dir, checkpoint_every, thin,
                          return_resume)


def _drive_sg_mcmc(kernels, prob, shared, key, n_burnin, n_keep, mesh,
                   checkpoint_dir, checkpoint_every, thin, return_resume):
    """Shared SGLD/SGHMC driver tail: init the chain batch, run the loop
    (pre-batched in shared-minibatch mode), assemble the result with the
    squeeze/thin/accept conventions, attach the warm resume."""
    init, step, batched_step = kernels
    state0 = jax.vmap(init)(prob.first_draw)
    loop_step = batched_step if shared else step

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            key, state0, loop_step, n_burnin, n_keep,
            collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin, pre_batched=shared,
        )
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = {}
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, n_burnin, n_keep)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result


class SGHMCState(NamedTuple):
    position: jax.Array   # unconstrained coordinates
    momentum: jax.Array   # the SGD-with-momentum velocity v
    draw_ind: jax.Array


def build_sghmc_kernel(prob: common.Problem, log_lik, data, n_data,
                       s: SGHMCSettings):
    """Returns ``(init, step, batched_step)`` for SGHMC in the paper's
    practical SGD-with-momentum parameterization (Chen, Fox & Guestrin
    2014, eq. 15)::

        v <- (1 - alpha) v + eta g + N(0, 2 (alpha - beta_hat) eta)
        x <- x + v

    where ``g`` is the stochastic posterior gradient (prior + (N/B)-scaled
    minibatch likelihood) and ``eta = step_size``. The friction term
    ``alpha`` absorbs the minibatch gradient noise; ``beta_hat`` optionally
    subtracts an estimate of it (0 by default, as in the paper). Like
    SGLD there is no Metropolis correction — the O(eta) discretization
    bias is pinned in tests against the exact discrete-Lyapunov
    stationary covariance of the linear (Gaussian) case."""
    dt = prob.dtype
    B = int(s.batch_size)
    N = int(n_data)
    scale = jnp.asarray(N / B, dt)
    eta = jnp.asarray(s.step_size, dt)
    alpha = jnp.asarray(s.friction_alpha, dt)
    noise_sd = jnp.sqrt(jnp.maximum(
        2.0 * (s.friction_alpha - s.beta_hat) * s.step_size, 0.0)
    ).astype(dt)

    grad_prior, grad_lik = _make_grad_parts(prob, log_lik)

    def init(position):
        return SGHMCState(position=position,
                          momentum=jnp.zeros_like(position),
                          draw_ind=jnp.asarray(0, jnp.int32))

    def _update(k_noise, state: SGHMCState, batch):
        g = grad_prior(state.position) + scale * grad_lik(state.position,
                                                          batch)
        xi = noise_sd * jax.random.normal(k_noise, (prob.n_vals,), dt)
        v = (1.0 - alpha) * state.momentum + eta * g + xi
        prop = state.position + v
        ok = jnp.all(jnp.isfinite(prop)) & jnp.all(jnp.isfinite(v))
        new_x = jnp.where(ok, prop, state.position)
        # a rejected draw also zeroes the momentum: carrying a huge or
        # non-finite v forward would re-explode the very next step
        new_v = jnp.where(ok, v, jnp.zeros_like(v))
        return (SGHMCState(position=new_x, momentum=new_v,
                           draw_ind=state.draw_ind + 1),
                {"accepted": ok})

    def step(key, state: SGHMCState):
        k_idx, k_noise = jax.random.split(key)
        idx = jax.random.randint(k_idx, (B,), 0, N)
        batch = jax.tree_util.tree_map(lambda a: a[idx], data)
        return _update(k_noise, state, batch)

    def batched_step(keys, states: SGHMCState):
        """Shared-minibatch variant — same rationale and key routing as
        SGLD's (one (B, ...) gather feeding one matrix product)."""
        pairs = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
        idx = jax.random.randint(pairs[0, 0], (B,), 0, N)
        batch = jax.tree_util.tree_map(lambda a: a[idx], data)

        def one(k_noise, st):
            return _update(k_noise, st, batch)

        return jax.vmap(one, axis_name=common.CHAIN_AXIS_NAME)(
            pairs[:, 1], states)

    return init, step, batched_step


def sghmc(initial_vals, log_prior, log_lik, data, settings=None, *,
          n_chains=None, key=None, mesh=None, checkpoint_dir=None,
          checkpoint_every=500, dtype=None, thin=1,
          minibatch="per-chain", return_resume=False) -> SamplerResult:
    """Run SGHMC (Chen, Fox & Guestrin 2014). Same calling convention,
    data contract, ``minibatch`` strategies, driver options, bounds
    support, and failure semantics as :func:`sgld`; the momentum carries
    gradient memory across draws, which explores tall posteriors faster
    than SGLD at an equal per-draw cost (one minibatch gradient)."""
    algo, s = resolve_settings(settings, "sghmc_settings", SGHMCSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if not callable(log_lik):
        raise TypeError("log_lik must be callable: log_lik(params, batch)")
    if not 0.0 < s.friction_alpha <= 1.0:
        raise ValueError(f"friction_alpha must be in (0, 1], got "
                         f"{s.friction_alpha}")
    if not 0.0 <= s.beta_hat < s.friction_alpha:
        raise ValueError("beta_hat must satisfy 0 <= beta_hat < "
                         "friction_alpha (it estimates a noise variance, "
                         "so it cannot be negative, and the injected noise "
                         "variance 2(alpha - beta_hat)eta must stay "
                         "positive)")
    if minibatch not in ("per-chain", "shared"):
        raise ValueError(f"minibatch must be 'per-chain' or 'shared', "
                         f"got {minibatch!r}")

    data, n_data = _validate_data(data, s.batch_size)
    prob = common.setup_problem(initial_vals, log_prior, algo, n_chains,
                                dtype)
    kernels = build_sghmc_kernel(prob, log_lik, data, n_data, s)
    return _drive_sg_mcmc(kernels, prob, minibatch == "shared", key,
                          s.n_burnin_draws, s.n_keep_draws, mesh,
                          checkpoint_dir, checkpoint_every, thin,
                          return_resume)
