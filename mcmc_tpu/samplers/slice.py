"""Univariate slice sampling within Gibbs (Neal 2003).

Beyond-reference sampler: the classic tuning-robust scalar sampler, swept
over coordinates. No reference analog — MCMCLib's only general-purpose
gradient-free chain sampler is RWMH, whose efficiency collapses when the
proposal scale is wrong; slice sampling self-tunes its scale every draw
(the stepping-out/shrinkage bracket adapts to the local slice width), so a
crude ``w`` within a couple orders of magnitude of the truth samples well.

One coordinate update (Neal 2003, Fig. 3 "stepping out" + Fig. 5
"shrinkage"):

    log_y = log f(x) + log U(0,1)                  (slice level)
    [L, R] = [x_i - w U(0,1), L + w]               (randomly placed)
    expand L (resp. R) by w while log f > log_y, with the total expansion
      budget max_step_out split randomly between the sides (the random
      allocation keeps the update reversible)
    repeat: x' ~ U(L, R); accept if log f(x') > log_y
            else shrink (x' < x_i -> L = x', else R = x')

A full draw sweeps all ``d`` coordinates (systematic-scan Gibbs). As the
bracket shrinks toward x_i the acceptance test approaches
``log f(x) > log_y``, true by construction, so termination is guaranteed
in exact arithmetic; ``max_shrink_steps`` is a safety cap (a capped
coordinate keeps its value and the draw reports as not accepted).

Accelerator-native design: the coordinate sweep is a ``lax.scan`` over the (static)
dimension, the stepping-out and shrinkage loops are ``lax.while_loop``s,
and the whole kernel vmaps over chains — every loop iteration is one
batched full log-kernel evaluation across the chain batch. Cost anatomy:
O(d) kernel evaluations per draw (times a small bracket factor, typically
2-6) — the price of coordinate-wise self-tuning; for smooth
high-dimensional targets prefer the gradient family, for latent-Gaussian
targets :func:`mcmc_tpu.elliptical_slice`.

Box constraints run through the same transform stack as every chain
sampler (unconstrained-space sweep on the box log-kernel + log-Jacobian).
Composes with ``mesh`` chain sharding, ``checkpoint_dir``, ``thin``, and
``return_resume`` via the common run loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import adaptation
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import SliceSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["slice_sampler", "SliceState", "build_slice_kernel"]

# E[slice width] for N(0, sd^2) is 2 sd E[sqrt(-2 ln U)] ~ 2.5 sd, so the
# adapted bracket w_i = 2.5 sd_i spans a typical slice in one placement
_W_PER_SD = 2.5


class SliceState(NamedTuple):
    position: jax.Array   # (n_vals,) unconstrained coordinates
    log_prob: jax.Array   # box log-kernel at position (-inf if non-finite)
    wv: adaptation.WindowedVariance   # width adaptation ((1,) when off)
    draw_ind: jax.Array


def build_slice_kernel(box_log_kernel, n_vals: int, dtype, w,
                       max_step_out: int, max_shrink: int,
                       precond_cfg=None):
    """Returns ``(init, step)``; ``step`` is the pure single-chain
    transition ``(key, state) -> (state, info)`` — one full coordinate
    sweep. Info: ``accepted`` (every coordinate found its slice point
    before the cap) and ``n_evals`` (log-kernel evaluations spent).

    ``precond_cfg`` (a :func:`mcmc_tpu.adaptation.make_precond_cfg`
    bundle) enables windowed width adaptation: per-dimension brackets
    ``w_i = 2.5 sd_i`` from Welford posterior-variance estimates adopted
    at Stan-style window ends during burn-in — the slice analog of
    RWMH/MALA proposal-covariance adaptation (an extension; the base
    algorithm is Neal 2003)."""
    w = jnp.broadcast_to(jnp.asarray(w, dtype), (n_vals,))
    max_step_out = int(max_step_out)
    max_shrink = int(max_shrink)
    adapting = precond_cfg is not None

    def _lp(x):
        v = box_log_kernel(x)
        return jnp.where(jnp.isfinite(v), v, -jnp.inf)

    def init(position):
        if adapting:
            wv = adaptation.wv_init(n_vals, dtype)
            # seed the adopted variance so the pre-first-window width is
            # exactly the user's w (2.5 sqrt(var) == w)
            wv = wv._replace(var=(w / _W_PER_SD) ** 2)
        else:
            wv = adaptation.wv_init(1, dtype)
        return SliceState(position=position, log_prob=_lp(position),
                          wv=wv, draw_ind=jnp.asarray(0, jnp.int32))

    def coord_update(carry, inputs):
        x, lp, all_ok, n_evals, width = carry
        i, key = inputs
        k_y, k_place, k_alloc, k_shrink = jax.random.split(key, 4)
        wi = width[i]
        xi = x[i]
        log_y = lp + jnp.log(jax.random.uniform(k_y, dtype=dtype))

        # --- stepping out, budget split randomly between the sides ------
        L = xi - wi * jax.random.uniform(k_place, dtype=dtype)
        R = L + wi
        j_budget = jax.random.randint(k_alloc, (), 0, max_step_out)
        k_budget = max_step_out - 1 - j_budget

        def lp_at(v):
            return _lp(x.at[i].set(v))

        def expand(side_sign, start, budget):
            # side_sign = -1 expands L leftward, +1 expands R rightward
            def cond(c):
                v, b, e = c
                return jnp.logical_and(b > 0, lp_at(v) > log_y)

            def body(c):
                v, b, e = c
                return (v + side_sign * wi, b - 1, e + 1)

            v, _b, e = lax.while_loop(
                cond, body, (start, budget, jnp.asarray(0, jnp.int32)))
            return v, e

        L, e_l = expand(jnp.asarray(-1.0, dtype), L, j_budget)
        R, e_r = expand(jnp.asarray(1.0, dtype), R, k_budget)

        # --- shrinkage ---------------------------------------------------
        def cond(c):
            done, it = c[0], c[1]
            return jnp.logical_and(~done, it < max_shrink)

        def body(c):
            done, it, lo, hi, k, xv, lpv = c
            k, sub = jax.random.split(k)
            prop = jax.random.uniform(sub, dtype=dtype, minval=lo,
                                      maxval=hi)
            lp_prop = lp_at(prop)
            ok = lp_prop > log_y
            xv = jnp.where(ok, prop, xv)
            lpv = jnp.where(ok, lp_prop, lpv)
            lo = jnp.where(jnp.logical_and(~ok, prop < xi), prop, lo)
            hi = jnp.where(jnp.logical_and(~ok, prop >= xi), prop, hi)
            return (done | ok, it + 1, lo, hi, k, xv, lpv)

        done, it, _lo, _hi, _k, xi_new, lp_new = lax.while_loop(
            cond, body, (jnp.asarray(False), jnp.asarray(0, jnp.int32),
                         L, R, k_shrink, xi, lp))
        x = x.at[i].set(xi_new)
        # the expansion's lp_at probes count cond evaluations too (one
        # extra per side for the final failed test when budget remains)
        n_evals = n_evals + e_l + e_r + it + 1
        return (x, lp_new, jnp.logical_and(all_ok, done), n_evals,
                width), None

    def step(key, state: SliceState):
        keys = jax.random.split(key, n_vals)
        idx = jnp.arange(n_vals)
        width = _W_PER_SD * jnp.sqrt(state.wv.var) if adapting else w
        (x, lp, all_ok, n_evals, _w), _ = lax.scan(
            coord_update,
            (state.position, state.log_prob, jnp.asarray(True),
             jnp.asarray(0, jnp.int32), width),
            (idx, keys))
        wv = state.wv
        if adapting:
            cfg = precond_cfg
            j = jnp.minimum(state.draw_ind, cfg["collect"].shape[0] - 1)
            in_warmup = state.draw_ind < cfg["n_adapt"]
            wv = adaptation.wv_update(
                wv, x, in_warmup & cfg["collect"][j],
                in_warmup & cfg["window_end"][j], cfg["axis_name"])
        return (SliceState(position=x, log_prob=lp, wv=wv,
                           draw_ind=state.draw_ind + 1),
                {"accepted": all_ok, "n_evals": n_evals})

    return init, step


def slice_sampler(initial_vals, log_kernel, settings=None, *, n_chains=None,
                  key=None, mesh=None, checkpoint_dir=None,
                  checkpoint_every=500, dtype=None, thin=1,
                  adapt_w=False, pooled_adaptation=False,
                  return_resume=False) -> SamplerResult:
    """Run univariate slice sampling within Gibbs (Neal 2003).

    ``log_kernel(params) -> scalar`` is a pure JAX function. Each draw
    sweeps every coordinate with a stepping-out/shrinkage scalar slice
    update — self-tuning scale, no acceptance rate to target.
    ``SliceSettings.w`` is the initial bracket width (scalar or
    per-dimension); being wrong by ~an order of magnitude costs a few
    extra kernel evaluations per coordinate, not statistical efficiency.

    ``accept_rate == 1.0`` is the healthy state (a slice sampler moves
    every draw; below 1.0 the ``max_shrink_steps`` cap bound — widen
    ``w`` or raise the cap). ``diagnostics["mean_kernel_evals"]`` reports
    log-kernel evaluations per draw (≈ d × bracket factor).

    ``adapt_w=True`` learns per-dimension widths ``w_i = 2.5 sd_i`` from
    windowed Welford posterior-variance estimates during burn-in (the
    slice analog of RWMH proposal-covariance adaptation; pooled across
    chains with ``pooled_adaptation=True``) — it cuts the kernel-eval
    cost on badly scaled targets, never the statistical efficiency.
    ``diagnostics["adapted_w"]`` reports the final widths.

    All the usual driver options apply (``n_chains``/``mesh``/
    ``checkpoint_dir``/``thin``/``return_resume``), and box constraints
    via the umbrella settings' ``vals_bound``/bounds.
    """
    algo, s = resolve_settings(settings, "slice_settings", SliceSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if int(s.max_step_out) < 1:
        raise ValueError(f"max_step_out must be >= 1, got {s.max_step_out}")
    if int(s.max_shrink_steps) < 1:
        raise ValueError(f"max_shrink_steps must be >= 1, got "
                         f"{s.max_shrink_steps}")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype)
    w = jnp.asarray(s.w, prob.dtype)
    if not bool(jnp.all(w > 0)):
        raise ValueError("w (initial bracket width) must be positive")

    precond_cfg = None
    if adapt_w:
        precond_cfg = adaptation.make_precond_cfg(
            s.n_burnin_draws, pooled_adaptation, common.CHAIN_AXIS_NAME)
    init, step = build_slice_kernel(prob.box_log_kernel, prob.n_vals,
                                    prob.dtype, w, s.max_step_out,
                                    s.max_shrink_steps, precond_cfg)
    state0 = jax.vmap(init)(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            key, state0, step, n_burnin, n_keep,
            collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin,
        )
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = {}
        if "n_evals" in infos:
            diagnostics["mean_kernel_evals"] = \
                infos["n_evals"].mean(axis=0)
        elif "n_evals" in infos.get("totals", {}):
            diagnostics["mean_kernel_evals"] = \
                jnp.asarray(infos["totals"]["n_evals"],
                            prob.dtype) / n_keep
        if adapt_w:
            diagnostics["adapted_w"] = \
                _W_PER_SD * jnp.sqrt(final_state.wv.var)
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
