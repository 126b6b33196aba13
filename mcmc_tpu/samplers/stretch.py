"""Affine-invariant ensemble sampler (Goodman & Weare stretch move).

No reference analog — MCMCLib's gradient-free population machinery is
DE-MCMC (reference src/de.cpp:30-273), whose difference proposals need a
hand-tuned noise scale ``par_b`` and whose gamma is fixed by dimension.
The stretch move (Goodman & Weare 2010; the default move of ``emcee``,
Foreman-Mackey et al. 2013) completes that family with the most widely used
gradient-free ensemble method: proposals are *affine-invariant* — sampling
efficiency is unchanged by any linear reparameterization, so ill-conditioned
and strongly correlated targets need no preconditioner, mass matrix, or
scale tuning at all.  One walker moves along the line through itself and a
partner walker drawn from the complementary half of the ensemble:

    Y = X_j + z (X_i - X_j),     z ~ g(z) ∝ 1/sqrt(z) on [1/a, a],

accepted with probability ``min(1, z^(d-1) exp(logK(Y) - logK(X_i)))``.

Accelerator-native design: the ensemble is a first-class batch axis.  Each sweep is
two vectorized half-updates (the parallel "red-black" scheme of
Foreman-Mackey et al. 2013, §3): half A proposes against the *current* half
B in one fused vmap — partner gather, z draws, kernel evaluations, accepts
all batched — then half B against the *updated* half A.  This is exactly
the serial stretch move's stationary distribution (each half-update is a
valid Metropolis-Hastings kernel holding the complementary half fixed), with
none of the reference DE pattern's OpenMP scheduling nondeterminism.  Under
``mesh`` the walker axis is sharded and each half-update all-gathers the
complementary half once over the interconnect (``mcmc_tpu.parallel.stretch_sharded``).

Bounded problems run on the unconstrained space via the box log-kernel
(+ log-Jacobian), with the initial ensemble placed there too — a deliberate
clean design (DE keeps the reference's mixed-space init quirk for parity;
the stretch sampler has no reference to be quirk-compatible with).

Output convention matches ``de``: draws ``(n_keep, n_walkers, n_vals)``;
``n_accept_draws`` totals accepted moves over kept sweeps across walkers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import StretchSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["stretch", "StretchState", "build_stretch_sweep"]


class StretchState(NamedTuple):
    X: jax.Array            # ensemble, (n_walkers, d), unconstrained coords
    kernel_vals: jax.Array  # (n_walkers,)


def _half_update(key, act_X, act_kv, comp_X, batched_kernel, par_a, n_vals):
    """Stretch-move update of the active half against a fixed complementary
    half; returns (X_new, kv_new, accepted)."""
    h = act_X.shape[0]
    dtype = act_X.dtype
    k_j, k_z, k_u = jax.random.split(key, 3)

    j = jax.random.randint(k_j, (h,), 0, comp_X.shape[0])
    partner = comp_X[j]

    # z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] by inverse-CDF:
    # z = ((a-1) u + 1)^2 / a
    u = jax.random.uniform(k_z, (h,), dtype)
    a = jnp.asarray(par_a, dtype)
    z = ((a - 1.0) * u + 1.0) ** 2 / a

    prop = partner + z[:, None] * (act_X - partner)
    prop_vals = batched_kernel(prop)
    prop_vals = jnp.where(jnp.isfinite(prop_vals), prop_vals, -jnp.inf)

    log_acc = (n_vals - 1) * jnp.log(z) + prop_vals - act_kv
    accepted = jnp.log(jax.random.uniform(k_u, (h,), dtype)) \
        < jnp.minimum(0.0, log_acc)

    X_new = jnp.where(accepted[:, None], prop, act_X)
    kv_new = jnp.where(accepted, prop_vals, act_kv)
    return X_new, kv_new, accepted


def build_stretch_sweep(box_log_kernel, cfg: StretchSettings, n_vals: int):
    """Returns ``sweep(key, state) -> (state, info)`` — one full ensemble
    sweep (both half-updates)."""
    n_w = int(cfg.n_walkers)
    h = n_w // 2
    batched_kernel = jax.vmap(box_log_kernel)

    def sweep(key, state: StretchState):
        k0, k1 = jax.random.split(key)
        X_a, X_b = state.X[:h], state.X[h:]
        kv_a, kv_b = state.kernel_vals[:h], state.kernel_vals[h:]

        X_a, kv_a, acc_a = _half_update(
            k0, X_a, kv_a, X_b, batched_kernel, cfg.par_a, n_vals)
        X_b, kv_b, acc_b = _half_update(
            k1, X_b, kv_b, X_a, batched_kernel, cfg.par_a, n_vals)

        new_state = StretchState(
            X=jnp.concatenate([X_a, X_b]),
            kernel_vals=jnp.concatenate([kv_a, kv_b]),
        )
        return new_state, {"accepted": jnp.concatenate([acc_a, acc_b])}

    return sweep


def stretch(initial_vals, log_kernel, settings=None, *, key=None, mesh=None,
            checkpoint_dir=None, checkpoint_every=500,
            dtype=None, thin=1, return_resume=False) -> SamplerResult:
    """Run the affine-invariant ensemble (stretch-move) sampler.

    ``thin=k`` advances ``k`` full ensemble sweeps per stored draw (the
    emcee ``thin_by`` convention, matching the chain samplers).
    ``return_resume=True`` attaches ``diagnostics["resume"](key, n_keep)``
    — a warm continuation from the final ensemble (incompatible with
    ``checkpoint_dir``).

    ``initial_vals`` (shape ``(n_vals,)``) centers the initial ensemble:
    walkers start in a Gaussian ball of radius ``init_spread`` around it on
    the *unconstrained* sampling space (the ``emcee`` convention).  Returns
    draws of shape ``(n_keep, n_walkers, n_vals)``.

    With ``mesh``, the walker axis is sharded across devices; each
    half-update all-gathers the complementary half once over the interconnect.
    """
    algo, s = resolve_settings(settings, "stretch_settings", StretchSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype)
    if not prob.squeeze:
        raise ValueError(
            f"stretch takes a single center point initial_vals of shape "
            f"(n_vals,); got a chain-batched array of shape "
            f"{tuple(jnp.shape(initial_vals))} — the ensemble size is "
            f"StretchSettings.n_walkers")
    n_vals, dt = prob.n_vals, prob.dtype
    n_w = int(s.n_walkers)
    if n_w < 4 or n_w % 2 != 0:
        raise ValueError(
            f"n_walkers must be an even number >= 4, got {n_w}")
    if not float(s.par_a) > 1.0:
        raise ValueError(f"par_a must be > 1, got {s.par_a}")
    if n_w < 2 * n_vals:
        # affine invariance needs the ensemble to span the space; emcee's
        # standard guidance is >= 2 d walkers
        raise ValueError(
            f"n_walkers={n_w} < 2 * n_vals={2 * n_vals}: the ensemble must "
            f"have at least twice as many walkers as dimensions")

    key, k_init = jax.random.split(key)
    center = prob.first_draw[0]
    spread = jnp.broadcast_to(jnp.asarray(s.init_spread, dt), (n_vals,))
    X0 = center + spread * jax.random.normal(k_init, (n_w, n_vals), dt)
    kv0 = jax.vmap(prob.box_log_kernel)(X0)
    kv0 = jnp.where(jnp.isfinite(kv0), kv0, -jnp.inf)
    state0 = StretchState(X=X0, kernel_vals=kv0)

    if mesh is None:
        sweep = build_stretch_sweep(prob.box_log_kernel, s, n_vals)
    else:
        from mcmc_tpu.parallel.stretch_sharded import build_sharded_stretch_sweep
        from mcmc_tpu.parallel.mesh import shard_chain_axis
        sweep = build_sharded_stretch_sweep(prob.box_log_kernel, s, n_vals,
                                            mesh)
        state0 = StretchState(X=shard_chain_axis(state0.X, mesh),
                              kernel_vals=shard_chain_axis(state0.kernel_vals,
                                                           mesh))
    sweep = common.thin_step(sweep, thin)

    if checkpoint_dir is not None:
        from mcmc_tpu.checkpoint import ChunkedRunner
        runner = ChunkedRunner(sweep, collect_fn=lambda st: st.X,
                               directory=checkpoint_dir, mesh=mesh,
                               single_key=True)
        _, draws, totals = runner.run(
            key, state0, n_draws=s.n_keep_draws, n_burnin=s.n_burnin_draws,
            chunk_size=checkpoint_every,
        )
        draws = common.finalize_draws(jnp.asarray(draws), prob)
        per_walker = jnp.asarray(totals["accepted"])
        return SamplerResult(
            draws=draws, n_accept_draws=per_walker.sum(),
            diagnostics=common.population_accept_diag_totals(
                per_walker, s.n_keep_draws, thin))

    run_jit = common.make_population_runner(sweep)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, (draws, accepted) = run_jit(state0, key, n_burnin,
                                                 n_keep)
        draws = common.finalize_draws(draws, prob)
        return SamplerResult(
            draws=draws, n_accept_draws=accepted.sum(),
            diagnostics=common.population_accept_diag(accepted, thin),
        ), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
