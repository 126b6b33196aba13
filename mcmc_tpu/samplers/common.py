"""Shared sampler machinery.

The reference repeats a driver skeleton in every sampler translation unit
(SURVEY.md §2b; e.g. reference src/rwmh.cpp:64-167): classify bounds, build a
box log-kernel closure, transform initial values, run a sequential draw loop,
back-transform kept draws, report acceptance. Here that skeleton is one pure
:func:`run_sampler_loop` — a :func:`jax.lax.scan` over draws of a vmapped
single-chain transition kernel — plus :class:`SPD`, a trace-time wrapper that
specializes identity / diagonal / dense covariance and preconditioner
matrices so the common identity case costs nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from mcmc_tpu import bounds as bounds_mod

__all__ = ["SPD", "Problem", "setup_problem", "run_sampler_loop",
           "finalize_draws", "CHAIN_AXIS_NAME"]

# named vmap axis over chains, available to kernels for cross-chain pooling
CHAIN_AXIS_NAME = "chain_axis"


@dataclass(frozen=True)
class SPD:
    """Trace-time specialization of a symmetric-positive-definite matrix.

    Provides the three products every Metropolis/Hamiltonian kernel needs
    (reference precomputes the same trio once per run, src/hmc.cpp:57-59):
    ``mv`` (M v), ``inv_mv`` (M^{-1} v), ``sqrt_mv`` (chol(M) v). For the
    default identity and for diagonal matrices these lower to element-wise
    ops instead of matmuls.
    """

    kind: str  # 'identity' | 'diag' | 'full'
    mv: Callable[[Any], Any]
    inv_mv: Callable[[Any], Any]
    sqrt_mv: Callable[[Any], Any]
    sqrt_t_mv: Callable[[Any], Any]  # chol(M)^T v (for log-density solves)
    mat: Any  # dense/diag representation or None for identity


def make_spd(mat, n_vals: int, dtype) -> SPD:
    """Build an :class:`SPD` from ``None`` (identity), scalar, 1-D diagonal,
    or 2-D dense input. Mirrors the reference's "use cov_mat if correctly
    sized else identity" rule (reference src/rwmh.cpp:58)."""
    if mat is None:
        ident = lambda v: v
        return SPD("identity", ident, ident, ident, ident, None)

    m = jnp.asarray(mat, dtype)
    if m.ndim == 0:
        m = jnp.full((n_vals,), m, dtype)
    if m.ndim == 1:
        if m.shape[0] != n_vals:
            raise ValueError(f"diagonal matrix has size {m.shape[0]}, expected {n_vals}")
        sq = jnp.sqrt(m)
        return SPD(
            "diag",
            mv=lambda v: m * v,
            inv_mv=lambda v: v / m,
            sqrt_mv=lambda v: sq * v,
            sqrt_t_mv=lambda v: sq * v,
            mat=m,
        )
    if m.shape != (n_vals, n_vals):
        raise ValueError(f"matrix has shape {m.shape}, expected ({n_vals},{n_vals})")
    chol = jnp.linalg.cholesky(m)
    # fail loud at setup: a not-quite-SPD matrix (e.g. an RBF Gram matrix
    # whose smallest eigenvalue is below f32 resolution) can NaN the
    # Cholesky on an accelerator, which would silently freeze every
    # proposal downstream
    if not bool(jnp.all(jnp.isfinite(chol))):
        raise ValueError(
            "matrix is not positive definite at this precision (Cholesky "
            "produced non-finite entries); add diagonal jitter (e.g. "
            "1e-4 * amplitude**2 for f32 kernel matrices) or use float64")
    inv = jnp.linalg.inv(m)
    return SPD(
        "full",
        mv=lambda v: m @ v,
        inv_mv=lambda v: inv @ v,
        sqrt_mv=lambda v: chol @ v,
        sqrt_t_mv=lambda v: chol.T @ v,
        mat=m,
    )


@dataclass(frozen=True)
class Problem:
    """Everything derived from (initial_vals, log_kernel, umbrella settings)."""

    n_vals: int
    dtype: Any
    vals_bound: bool
    codes: Any
    lower_bounds: Any
    upper_bounds: Any
    log_kernel: Callable          # user kernel, constrained space
    box_log_kernel: Callable      # unconstrained space (+ log-Jacobian)
    first_draw: Any               # (n_chains, n_vals) unconstrained
    n_chains: int
    squeeze: bool                 # drop the chain axis in the result


def setup_problem(initial_vals, log_kernel, algo, n_chains: Optional[int], dtype=None) -> Problem:
    """Common preamble of every sampler (reference src/rwmh.cpp:64-103)."""
    if callable(initial_vals) and not hasattr(initial_vals, "__array__"):
        raise TypeError(
            "initial_vals is a function — the argument order is "
            "(initial_vals, log_kernel, ...), initial values first")
    if not callable(log_kernel):
        raise TypeError(
            f"log_kernel must be callable (a log-density function); got "
            f"{type(log_kernel).__name__}")
    try:
        x0 = jnp.asarray(initial_vals, dtype)
    except (TypeError, ValueError) as e:
        raise TypeError(
            f"initial_vals must be array-like; got "
            f"{type(initial_vals).__name__}") from e
    dtype = x0.dtype
    squeeze = x0.ndim == 1 and (n_chains is None or n_chains == 1)
    if x0.ndim == 1:
        n = 1 if n_chains is None else int(n_chains)
        x0 = jnp.broadcast_to(x0, (n, x0.shape[0]))
    elif (x0.ndim == 2 and n_chains is not None
          and x0.shape[0] != int(n_chains)):
        raise ValueError(
            f"initial_vals has {x0.shape[0]} rows (one per chain) but "
            f"n_chains={n_chains}; drop n_chains or match the leading axis")
    n_chains_eff, n_vals = x0.shape

    vals_bound = bool(algo.vals_bound)
    if vals_bound:
        lb = jnp.asarray(algo.lower_bounds, dtype) if algo.lower_bounds is not None \
            else jnp.full((n_vals,), -jnp.inf, dtype)
        ub = jnp.asarray(algo.upper_bounds, dtype) if algo.upper_bounds is not None \
            else jnp.full((n_vals,), jnp.inf, dtype)
    else:
        lb = jnp.full((n_vals,), -jnp.inf, dtype)
        ub = jnp.full((n_vals,), jnp.inf, dtype)

    codes = bounds_mod.determine_bounds_type(vals_bound, n_vals, lb, ub)
    box = bounds_mod.make_box_log_kernel(log_kernel, vals_bound, codes, lb, ub)

    first = x0
    if vals_bound:
        first = jax.vmap(lambda v: bounds_mod.transform(v, codes, lb, ub))(x0)

    return Problem(
        n_vals=n_vals, dtype=dtype, vals_bound=vals_bound, codes=codes,
        lower_bounds=lb, upper_bounds=ub, log_kernel=log_kernel,
        box_log_kernel=box, first_draw=first, n_chains=n_chains_eff,
        squeeze=squeeze,
    )


def _split_keys(keys):
    pair = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
    return pair[:, 0], pair[:, 1]


def tally_accepts(infos):
    """Post-burn-in acceptance count per chain, from either the in-memory
    info trace or a checkpointed run's accumulated total."""
    if "accepted" in infos:
        return infos["accepted"].sum(axis=0)
    return jnp.asarray(infos["totals"]["accepted"])


def thin_step(step_fn, thin: int, batched: bool = False):
    """Wrap a single-chain kernel so each call advances ``thin`` transitions
    and reports one draw — the draw-history-scaling lever the reference
    lacks (SURVEY.md §5: stored draws grow with run length; thinning keeps
    the buffer at ``n_keep`` rows while the chain advances ``n_keep*thin``
    steps). Composes with vmap, mesh sharding, and the checkpoint runner
    because it stays inside the ``(key, state) -> (state, info)`` contract.

    Info aggregation over the window: boolean entries (``accepted``,
    ``diverged``) become int32 *counts* over the window's transitions;
    everything else reports the last transition's value.
    """
    thin = int(thin)
    if thin < 1:
        raise ValueError(f"thin must be >= 1, got {thin}")
    if thin == 1:
        return step_fn

    def step(key, state):
        if batched:
            # key is the (n_chains,) per-chain key batch of a pre-batched
            # kernel: split each chain's key into the window
            keys = jnp.swapaxes(
                jax.vmap(lambda k: jax.random.split(k, thin))(key), 0, 1)
        else:
            keys = jax.random.split(key, thin)

        def inner(st, k):
            st, info = step_fn(k, st)
            return st, info

        state, infos = lax.scan(inner, state, keys)
        info = jax.tree_util.tree_map(
            lambda v: v.astype(jnp.int32).sum(axis=0)
            if v.dtype == jnp.bool_ else v[-1],
            infos,
        )
        return state, info

    return step


def make_population_runner(sweep):
    """Jitted driver for the single-key population samplers (de, demcz,
    stretch): ``sweep(key, state) -> (state, info)`` over the whole
    population at once. Scans ``n_burnin`` discarded sweeps then ``n_keep``
    kept ones, collecting ``(state.X, info["accepted"])`` per kept sweep;
    the per-sweep key is split off a running key exactly as the checkpoint
    runner's single-key convention does, so the two paths stay
    bit-identical. Returns ``run(state0, key, n_burnin, n_keep) ->
    (final_state, (draws, accepted))`` with static lengths."""

    def body(carry, _):
        state, k = carry
        k, sub = jax.random.split(k)
        state, info = sweep(sub, state)
        return (state, k), (state.X, info["accepted"])

    def run(state0, key, n_burnin, n_keep):
        carry = (state0, key)
        if n_burnin > 0:
            def body_burn(carry, _):
                carry, _out = body(carry, None)
                return carry, None
            carry, _ = lax.scan(body_burn, carry, None, length=n_burnin)
        carry, out = lax.scan(body, carry, None, length=n_keep)
        return carry[0], out

    return jax.jit(run, static_argnums=(2, 3))


def population_accept_diag(accepted, thin: int):
    """Population acceptance diagnostics from per-sweep stacked ``accepted``
    (bool, or int32 window counts under ``thin``): a per-walker probability
    plus the ``thin`` record the ``accept_rate`` property divides by."""
    diag = {"accept_rate_per_walker":
            accepted.astype(jnp.float32).mean(axis=0) / int(thin)}
    if int(thin) > 1:
        diag["thin"] = int(thin)
    return diag


def population_accept_diag_totals(per_walker, n_keep: int, thin: int):
    """Same contract as :func:`population_accept_diag`, from the checkpoint
    runner's per-walker transition-count totals."""
    diag = {"accept_rate_per_walker":
            jnp.asarray(per_walker) / (int(n_keep) * int(thin))}
    if int(thin) > 1:
        diag["thin"] = int(thin)
    return diag


def run_sampler_loop(key, state0, step_fn, n_burnin, n_keep, collect_fn,
                     mesh=None, checkpoint_dir=None, checkpoint_every=500,
                     thin=1, pre_batched=False):
    """Burn-in + keep scans of a vmapped transition kernel.

    ``state0`` is chain-batched on the leading axis; ``step_fn`` is the
    single-chain pure kernel ``(key, state) -> (state, info)``; ``info`` must
    contain an ``"accepted"`` entry. Acceptance is only tallied in the keep
    phase, matching the reference (src/rwmh.cpp:140-142).

    With ``mesh``, the chain axis is sharded over the device mesh and the
    whole run is jitted so GSPMD partitions the scan body data-parallel —
    the multi-chip replacement for the reference's OpenMP threads
    (SURVEY.md §2d).

    With ``checkpoint_dir``, the run executes in restartable chunks through
    :class:`mcmc_tpu.checkpoint.ChunkedRunner` — kept draws stream to the
    native draw sink and a killed run resumes bit-identically. In that mode
    ``infos`` carries only ``{"totals": {...}}`` — per-chain sums of every
    per-draw info entry over kept draws (per-draw traces are not retained);
    it composes with ``mesh`` (chunks run GSPMD-partitioned).

    Returns ``(final_state, draws, infos)`` where ``draws`` stacks
    ``collect_fn(state)`` over kept iterations: shape ``(n_keep, n_chains, ...)``.

    ``thin=k`` advances ``k`` transitions per draw (burn-in and keep phases
    alike, the emcee ``thin_by`` convention) while storing only ``n_keep``
    rows — see :func:`thin_step` for the info-aggregation contract.

    ``pre_batched=True`` means ``step_fn`` already handles the chain batch
    (``(keys (n_chains,), states) -> (states, infos)``) and must not be
    vmapped here — used by kernels with cross-chain structure per draw,
    e.g. SGLD's shared-minibatch mode.
    """
    step_fn = thin_step(step_fn, thin, batched=pre_batched)
    if checkpoint_dir is not None:
        from mcmc_tpu.checkpoint import ChunkedRunner
        runner = ChunkedRunner(
            step_fn if pre_batched else
            jax.vmap(step_fn, axis_name=CHAIN_AXIS_NAME), collect_fn,
            checkpoint_dir, mesh=mesh,
        )
        final, draws, totals = runner.run(
            key, state0, n_draws=n_keep, n_burnin=n_burnin,
            chunk_size=checkpoint_every,
        )
        # the sink hands back a host memmap; keep it host-resident rather
        # than materializing the full history on device — exactly the long
        # runs checkpointing targets are the ones that don't fit.
        # Downstream jnp ops transfer on demand; bounded runs transfer once
        # in finalize_draws for the back-transform, as before.
        return final, np.asarray(draws), {"totals": totals}

    n_chains = jax.tree_util.tree_leaves(state0)[0].shape[0]
    keys = jax.random.split(key, n_chains)
    # the named chain axis lets kernels pool cross-chain statistics with
    # lax.pmean (lowers to a psum collective when the axis is mesh-sharded).
    # pre_batched kernels handle the chain axis themselves (e.g. SGLD's
    # shared-minibatch mode gathers ONE batch per draw for all chains).
    batched_step = step_fn if pre_batched else \
        jax.vmap(step_fn, axis_name=CHAIN_AXIS_NAME)

    def run(state0, keys):
        def body(carry, _):
            st, ks = carry
            ks, subs = _split_keys(ks)
            st, info = batched_step(subs, st)
            return (st, ks), (st, info)

        def body_burn(carry, _):
            carry, _out = body(carry, None)
            return carry, None

        carry = (state0, keys)
        if n_burnin > 0:
            carry, _ = lax.scan(body_burn, carry, None, length=n_burnin)

        def body_keep(carry, _):
            carry, (st, info) = body(carry, None)
            return carry, (collect_fn(st), info)

        carry, (draws, infos) = lax.scan(body_keep, carry, None, length=n_keep)
        return carry[0], draws, infos

    if mesh is not None:
        from mcmc_tpu.parallel.mesh import shard_chain_axis
        state0 = shard_chain_axis(state0, mesh)
        keys = shard_chain_axis(keys, mesh)
        run = jax.jit(run)
    return run(state0, keys)


def attach_resume(result, assemble, final_state):
    """Attach a warm-continuation closure to a sampler result.

    ``assemble(key, state0, n_burnin, n_keep) -> (SamplerResult, final_state)``
    is the entry point's run-and-assemble tail. The attached
    ``result.diagnostics["resume"](key, n_keep)`` runs ``n_keep`` further
    draws from the final kernel state — no re-warmup, adaptation state
    carried (and frozen, since ``draw_ind`` continues past ``n_adapt``) —
    and itself carries a fresh ``"resume"``. This is the primitive behind
    ``fit``'s run-until-converged mode.
    """
    def make(fs):
        def resume(key, n_keep):
            r2, fs2 = assemble(key, fs, 0, n_keep)
            r2.diagnostics["resume"] = make(fs2)
            return r2
        return resume
    result.diagnostics["resume"] = make(final_state)
    return result


def finalize_draws(draws, prob: Problem):
    """Back-transform kept draws to constrained space — the vectorized analog
    of the reference's OpenMP inv_transform pass (src/rwmh.cpp:156-163)."""
    if prob.vals_bound:
        draws = bounds_mod.inv_transform(
            draws, prob.codes, prob.lower_bounds, prob.upper_bounds
        )
    return draws
