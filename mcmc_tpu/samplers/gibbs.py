"""Compositional block-Gibbs sampling.

No reference analog (kthohr/mcmc has no kernel-composition facility;
SURVEY.md §2b lists only monolithic whole-vector samplers). This module
adds the classic missing workflow capability: partition the parameter
vector into blocks and update each block in sequence with its own
transition kernel, conditioned on the current values of the others —
Metropolis-within-Gibbs, HMC-within-Gibbs, slice-within-Gibbs, and exact
conjugate conditional draws, freely mixed.

Accelerator-first design: one Gibbs sweep is a single fused XLA program — the
per-block sub-kernels are the library's own pure ``(key, state) ->
(state, info)`` builders (:func:`build_rwmh_kernel`,
:func:`build_hmc_kernel`, :func:`build_slice_kernel`) instantiated at
trace time on the *conditional* log-density ``lp_b(x_b) =
log_kernel(full with block b replaced)``, so the block loop is unrolled
into one compiled sweep, vmapped over chains and scanned over draws by
the standard driver (:func:`mcmc_tpu.samplers.common.run_sampler_loop`).
Everything composes: ``n_chains``, ``mesh`` sharding, ``thin``,
``checkpoint_dir``, ``return_resume``, and box constraints.

Semantics and costs:

- MH/slice blocks run in the *unconstrained* space (the full box
  log-kernel including the log-Jacobian; Jacobian terms of the frozen
  blocks are constants in the conditional and cancel in MH ratios).
- Exact blocks run in the *constrained* space: the user callable
  receives ``(key, full_constrained)`` and returns the block's new
  constrained values — the natural contract for conjugate conditionals.
- Because a block's cached conditional log-density goes stale the moment
  another block moves, each block re-evaluates the conditional at its
  current position once per sweep before transitioning (one extra
  log-kernel evaluation per block per sweep — the unavoidable Gibbs
  bookkeeping cost; the reference-style monolithic kernels avoid it by
  never conditioning).
- Per-block step-size/scale dual-averaging adaptation runs against the
  moving conditional — standard adaptive-within-Gibbs practice; frozen
  after ``n_burnin_draws`` sweeps like every other sampler here.

Block spec: ``blocks=[(indices, method[, opts]), ...]`` where ``indices``
is a list/array of coordinate indices, ``method`` is ``"rwmh" | "hmc" |
"slice"`` or a callable exact conditional, and ``opts`` is a per-block
dict (``scale``, ``step_size``, ``n_leap_steps``, ``w``, ``adapt``,
``target_accept``). Blocks must be disjoint and cover every coordinate.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from mcmc_tpu import adaptation
from mcmc_tpu import bounds as bounds_mod
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import GibbsSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu.samplers.rwmh import build_rwmh_kernel
from mcmc_tpu.samplers.hmc import build_hmc_kernel
from mcmc_tpu.samplers.slice import build_slice_kernel

__all__ = ["gibbs", "GibbsState"]


class GibbsState(NamedTuple):
    position: jax.Array   # (n_vals,) unconstrained full vector
    substates: tuple      # per-block kernel states ((0,) zeros for exact)


# Per-method option whitelists: an unknown key (a typo, or an option meant
# for another method) raises instead of silently running with defaults —
# matching the module's otherwise-strict block-spec validation.
_ALLOWED_OPTS = {
    "rwmh": {"scale", "adapt", "target_accept"},
    "hmc": {"step_size", "n_leap_steps", "adapt", "target_accept"},
    "slice": {"w", "max_step_out", "max_shrink_steps"},
    "exact": set(),
}


def _parse_blocks(blocks, n_vals):
    """Validate the block spec: disjoint integer index sets covering every
    coordinate. Returns [(np_indices, method, opts), ...]."""
    if not isinstance(blocks, (list, tuple)) or len(blocks) == 0:
        raise ValueError("blocks must be a non-empty list of "
                         "(indices, method[, opts]) tuples")
    parsed = []
    seen = np.zeros(n_vals, dtype=bool)
    for b, spec in enumerate(blocks):
        if not isinstance(spec, (list, tuple)) or len(spec) not in (2, 3):
            raise ValueError(
                f"block {b}: expected (indices, method) or "
                f"(indices, method, opts), got {spec!r}")
        idx = np.atleast_1d(np.asarray(spec[0]))
        if idx.ndim != 1 or idx.size == 0 or not np.issubdtype(
                idx.dtype, np.integer):
            raise ValueError(f"block {b}: indices must be a non-empty 1-D "
                             f"integer array, got {spec[0]!r}")
        if idx.min() < 0 or idx.max() >= n_vals:
            raise ValueError(f"block {b}: indices out of range for "
                             f"{n_vals} parameters: {idx.tolist()}")
        if np.unique(idx).size != idx.size or seen[idx].any():
            raise ValueError(f"block {b}: indices overlap another block "
                             f"(blocks must be disjoint): {idx.tolist()}")
        seen[idx] = True
        method = spec[1]
        if not callable(method) and method not in ("rwmh", "hmc", "slice"):
            raise ValueError(
                f"block {b}: method must be 'rwmh', 'hmc', 'slice', or a "
                f"callable exact conditional, got {method!r}")
        opts = dict(spec[2]) if len(spec) == 3 else {}
        allowed = (_ALLOWED_OPTS["exact"] if callable(method)
                   else _ALLOWED_OPTS[method])
        unknown = sorted(set(opts) - allowed)
        if unknown:
            name = "exact" if callable(method) else method
            raise ValueError(
                f"block {b}: unknown option(s) {unknown} for method "
                f"{name!r}; allowed: {sorted(allowed) or '(none)'}")
        parsed.append((idx, method, opts))
    if not seen.all():
        missing = np.nonzero(~seen)[0].tolist()
        raise ValueError(
            f"blocks must cover every coordinate; missing {missing} "
            f"(freeze a coordinate by giving it an exact block that "
            f"returns it unchanged)")
    return parsed


def _masked_lp(box, full, idx):
    """Conditional box log-density of block ``idx`` given the rest of
    ``full``; non-finite values forced to -inf (reference rejection
    semantics, src/rwmh.cpp:127-129)."""
    def lp(xb):
        v = box(full.at[idx].set(xb))
        return jnp.where(jnp.isfinite(v), v, -jnp.inf)
    return lp


def _make_handlers(parsed, prob, n_burnin):
    """One handler per block: ``build(lp_cond) -> (init, step)`` plus a
    ``refresh`` that re-evaluates the cached conditional density fields
    (they go stale when other blocks move)."""
    handlers = []
    for idx_np, method, opts in parsed:
        idx = jnp.asarray(idx_np)
        d_b = int(idx_np.size)

        if callable(method):
            fn = method

            def make_exact(idx=idx, fn=fn):
                def step(key, full):
                    if prob.vals_bound:
                        full_con = bounds_mod.inv_transform(
                            full, prob.codes, prob.lower_bounds,
                            prob.upper_bounds)
                        xb_con = jnp.asarray(fn(key, full_con),
                                             full.dtype)
                        full_con = full_con.at[idx].set(xb_con)
                        xb_unc = bounds_mod.transform(
                            full_con, prob.codes, prob.lower_bounds,
                            prob.upper_bounds)[idx]
                    else:
                        xb_unc = jnp.asarray(fn(key, full), full.dtype)
                    return xb_unc
                return step

            handlers.append(("exact", idx, make_exact(), None, None))
            continue

        if method == "rwmh":
            adapt_cfg = None
            if opts.get("adapt", True):
                adapt_cfg = {
                    "n_burnin": n_burnin,
                    "target": opts.get("target_accept",
                                       adaptation.TARGET_ACCEPT["rwmh"]),
                }
            scale = float(opts.get("scale", 1.0))

            def build(lp, scale=scale, adapt_cfg=adapt_cfg):
                return build_rwmh_kernel(lp, lambda v: v, scale, adapt_cfg)

            def refresh(sub, lp):
                return sub._replace(log_prob=lp(sub.position))

        elif method == "hmc":
            adapt_cfg = None
            if opts.get("adapt", True):
                adapt_cfg = {
                    "n_burnin": n_burnin,
                    "target": opts.get("target_accept",
                                       adaptation.TARGET_ACCEPT["hmc"]),
                }
            step_size = float(opts.get("step_size", 0.1))
            n_leap = int(opts.get("n_leap_steps", 10))
            ident = common.make_spd(None, d_b, prob.dtype)

            def build(lp, step_size=step_size, n_leap=n_leap,
                      adapt_cfg=adapt_cfg, ident=ident):
                return build_hmc_kernel(lp, jax.grad(lp), ident,
                                        step_size, n_leap, adapt_cfg)

            def refresh(sub, lp):
                return sub._replace(potential=-lp(sub.position))

        else:  # slice
            w = opts.get("w", 1.0)
            max_step_out = int(opts.get("max_step_out", 8))
            max_shrink = int(opts.get("max_shrink_steps", 32))

            def build(lp, w=w, d_b=d_b, mso=max_step_out,
                      msh=max_shrink):
                return build_slice_kernel(lp, d_b, prob.dtype, w, mso, msh)

            def refresh(sub, lp):
                return sub._replace(log_prob=lp(sub.position))

        handlers.append((method, idx, None, build, refresh))
    return handlers


def build_gibbs_kernel(box_log_kernel, handlers, prob):
    """Single-chain Gibbs sweep kernel ``(key, state) -> (state, info)``.
    Info: ``accepted`` (every MH block accepted; exact/slice blocks count
    as accepted per their own conventions) and ``block_accepted``
    (per-block bools)."""
    n_blocks = len(handlers)

    def init(position):
        subs = []
        for kind, idx, exact_step, build, _refresh in handlers:
            if kind == "exact":
                subs.append(jnp.zeros((0,), position.dtype))
            else:
                lp = _masked_lp(box_log_kernel, position, idx)
                sub_init, _ = build(lp)
                subs.append(sub_init(position[idx]))
        return GibbsState(position=position, substates=tuple(subs))

    def step(key, state: GibbsState):
        full = state.position
        subs = list(state.substates)
        keys = jax.random.split(key, n_blocks)
        accepts = []
        for b, (kind, idx, exact_step, build, refresh) in enumerate(handlers):
            if kind == "exact":
                xb = exact_step(keys[b], full)
                full = full.at[idx].set(xb)
                accepts.append(jnp.asarray(True))
                continue
            lp = _masked_lp(box_log_kernel, full, idx)
            _, bstep = build(lp)
            sub = refresh(subs[b], lp)
            sub, info = bstep(keys[b], sub)
            full = full.at[idx].set(sub.position)
            subs[b] = sub
            accepts.append(info["accepted"])
        info = {
            "accepted": jnp.stack(accepts).all(),
            "block_accepted": jnp.stack(accepts),
        }
        return GibbsState(position=full, substates=tuple(subs)), info

    return init, step


def gibbs(initial_vals, log_kernel, settings=None, *, blocks,
          n_chains=None, key=None, mesh=None, checkpoint_dir=None,
          checkpoint_every=500, dtype=None, thin=1,
          return_resume=False) -> SamplerResult:
    """Run compositional block-Gibbs (module docstring for the design).

    ``blocks=[(indices, method[, opts]), ...]`` partitions the parameter
    vector; each sweep updates the blocks in order. ``method`` is
    ``"rwmh"`` / ``"hmc"`` / ``"slice"`` (the library's own kernels on
    the conditional density, with per-block dual-averaging adaptation on
    by default for rwmh/hmc) or a callable ``fn(key, full_constrained) ->
    new_block_values`` drawing the block's exact conditional.

    ``diagnostics["block_accept_rate"]`` reports the per-block
    post-burn-in acceptance probability (exact blocks report 1.0; slice
    blocks report the fraction of sweeps where every coordinate found
    its slice point).
    """
    algo, s = resolve_settings(settings, "gibbs_settings", GibbsSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype)
    parsed = _parse_blocks(blocks, prob.n_vals)
    handlers = _make_handlers(parsed, prob, s.n_burnin_draws)
    init, step = build_gibbs_kernel(prob.box_log_kernel, handlers, prob)
    state0 = jax.vmap(init)(prob.first_draw)
    methods = ["exact" if callable(m) else m for _i, m, _o in parsed]

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            key, state0, step, n_burnin, n_keep,
            collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin,
        )
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = {"block_methods": methods}
        if "block_accepted" in infos:
            diagnostics["block_accept_rate"] = (
                infos["block_accepted"].astype(jnp.float32).mean(axis=0)
                / int(thin))
        elif "block_accepted" in infos.get("totals", {}):
            diagnostics["block_accept_rate"] = (
                jnp.asarray(infos["totals"]["block_accepted"],
                            jnp.float32) / (n_keep * int(thin)))
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics["block_accept_rate"] = \
                diagnostics["block_accept_rate"][0]
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
