"""ChEES-HMC: adaptive-trajectory HMC without tree building.

No reference analog — this is the framework's accelerator-first answer to the
question NUTS answers on CPUs. NUTS's recursive doubling is control-flow
heavy and, under ``vmap``, every chain pays the deepest tree in the batch
each draw (the straggler cost; see samplers/nuts.py). ChEES-HMC (Hoffman,
Radul & Sountsov, AISTATS 2021, "An Adaptive-MCMC Scheme for Setting
Trajectory Lengths in Hamiltonian Monte Carlo") instead runs plain
fixed-cost leapfrog trajectories whose *shared* length is learned by
stochastic gradient ascent on the ChEES criterion

    ChEES(T) = 1/4 * E[ (||x' - E x'||^2 - ||x - E x||^2)^2 ],

the change in the estimator of the expected squared jump distance. The
cross-chain expectations are exactly what a large vmapped/sharded chain
batch provides for free (``lax.pmean`` over the named chain axis — a psum
collective when chains span a mesh). Every chain runs the *same* number of
leapfrog steps per draw (jittered by a shared Halton sequence to avoid
resonances), so the batch is perfectly lockstep: no stragglers, no masked
lanes, no tree bookkeeping — the accelerator-native trade.

Per draw:
- trajectory length ``t = h_i * T`` with ``h_i`` the base-2 van der Corput
  (Halton) point of the draw index; ``steps = max(1, round(t / eps))``;
- standard leapfrog + Metropolis accept (min(0, .) — no reference clamp
  quirk to reproduce, there is no reference);
- ``T`` is updated by Adam on ``log T`` with the per-chain gradient
  estimate ``alpha * (||x'-mu'||^2 - ||x-mu||^2) * <x'-mu', v'>`` pooled
  across chains (``v' = M^{-1} p'`` is the end velocity), following the
  paper's estimator with acceptance-probability weights;
- ``eps`` is tuned by dual averaging toward 0.651 (the optimal acceptance
  rate for jittered-trajectory HMC derived in the paper);
- optional windowed mass adaptation, diagonal or dense full-covariance
  (the shared adaptation.window_schedule / windowed_mass_update
  machinery).

All adaptation freezes after ``n_burnin_draws``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import adaptation
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import ChEESSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["chees", "ChEESState", "build_chees_kernel"]


def _vdc_base2(n):
    """Base-2 van der Corput point of positive int32 ``n`` in (0, 1):
    bit-reverse as a binary fraction (the Halton jitter sequence)."""
    v = n.astype(jnp.uint32)
    v = ((v >> 1) & jnp.uint32(0x55555555)) | ((v & jnp.uint32(0x55555555)) << 1)
    v = ((v >> 2) & jnp.uint32(0x33333333)) | ((v & jnp.uint32(0x33333333)) << 2)
    v = ((v >> 4) & jnp.uint32(0x0F0F0F0F)) | ((v & jnp.uint32(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & jnp.uint32(0x00FF00FF)) | ((v & jnp.uint32(0x00FF00FF)) << 8)
    v = (v >> 16) | (v << 16)
    # uint32 -> f64-safe float via two 16-bit halves (f32 keeps ~24 bits)
    hi = (v >> 16).astype(jnp.float32)
    lo = (v & jnp.uint32(0xFFFF)).astype(jnp.float32)
    return (hi * 65536.0 + lo) * (2.0 ** -32)


class ChEESState(NamedTuple):
    position: jax.Array
    potential: jax.Array     # U = -box_log_kernel(position)
    da: adaptation.DualAveraging   # step-size tuning
    log_T: jax.Array         # log trajectory length (shared across chains)
    adam_m: jax.Array        # Adam first/second moments for log_T
    adam_v: jax.Array
    wv: adaptation.WindowedVariance  # optional diagonal mass
    mSigma: jax.Array        # dense mass: posterior covariance ((1,) diag)
    mchol: jax.Array         # its Cholesky ((1,) in diag mode)
    mm2: jax.Array           # dense outer-product accumulator ((1,) diag)
    draw_ind: jax.Array


def build_chees_kernel(box_log_kernel, grad_fn, cfg: ChEESSettings,
                       n_adapt: int, adapt_mass=False, mass_cfg=None):
    """Batch-pooled ChEES transition ``(key, state) -> (state, info)``.

    Must run under ``vmap``/``shard_map`` with the chain axis named
    ``common.CHAIN_AXIS_NAME`` — the criterion's expectations pool over it.
    ``adapt_mass``: False / True / "diag" / "dense" (mass_cfg supplies the
    window schedule).
    """
    max_steps = int(cfg.max_leap_steps)
    adam_lr = float(cfg.adam_learning_rate)
    target = float(cfg.target_accept_rate)
    mass_mode = {False: None, True: "diag"}.get(adapt_mass, adapt_mass)
    if mass_mode not in (None, "diag", "dense"):
        raise ValueError(f"adapt_mass must be False/True/'diag'/'dense', "
                         f"got {adapt_mass!r}")
    dense = mass_mode == "dense"
    adapt_mass = mass_mode is not None

    def potential(z):
        u = -box_log_kernel(z)
        return jnp.where(jnp.isfinite(u), u, jnp.inf)

    def step(key, state: ChEESState):
        dtype = state.position.dtype
        dim = state.position.shape[0]
        k_mom, k_acc = jax.random.split(key)

        adapting = state.draw_ind < n_adapt
        eps = jnp.exp(jnp.where(adapting, state.da.log_eps,
                                state.da.log_eps_bar))
        inv_mass = state.wv.var if (adapt_mass and not dense) \
            else jnp.ones((dim,), dtype)

        # shared jittered trajectory length -> shared leapfrog count
        h = _vdc_base2(state.draw_ind + 1).astype(dtype)
        T = jnp.exp(state.log_T)
        t_len = h * T
        steps = jnp.clip(jnp.round(t_len / eps).astype(jnp.int32), 1, max_steps)

        noise = jax.random.normal(k_mom, (dim,), dtype)
        if dense:
            # Sigma = L L^T; p ~ N(0, Sigma^{-1})
            p0 = jax.scipy.linalg.solve_triangular(state.mchol.T, noise,
                                                   lower=False)
            prev_K = 0.5 * p0 @ (state.mSigma @ p0)
        else:
            p0 = noise * lax.rsqrt(inv_mass)
            prev_K = 0.5 * jnp.sum(p0 * p0 * inv_mass)

        def leap_body(c):
            i, z, p, g = c
            p_half = p + 0.5 * eps * g
            if dense:
                z_new = z + eps * (state.mSigma @ p_half)
            else:
                z_new = z + eps * (inv_mass * p_half)
            g_new = grad_fn(z_new)
            p_new = p_half + 0.5 * eps * g_new
            return i + 1, z_new, p_new, g_new

        g0 = grad_fn(state.position)
        _, z_prop, p_prop, _ = lax.while_loop(
            lambda c: c[0] < steps, leap_body,
            (jnp.asarray(0, jnp.int32), state.position, p0, g0),
        )

        prop_U = potential(z_prop)
        if dense:
            prop_K = 0.5 * p_prop @ (state.mSigma @ p_prop)
        else:
            prop_K = 0.5 * jnp.sum(p_prop * p_prop * inv_mass)
        log_alpha = jnp.minimum(0.0, -(prop_U + prop_K)
                                + (state.potential + prev_K))
        alpha = jnp.where(jnp.isnan(log_alpha), 0.0, jnp.exp(log_alpha))
        u = jax.random.uniform(k_acc, dtype=dtype)
        accepted = u < alpha

        position = jnp.where(accepted, z_prop, state.position)
        pot_out = jnp.where(accepted, prop_U, state.potential)

        # --- ChEES gradient for T (pooled across the chain axis) ---
        # Distances are measured in the mass-matrix metric ||d||_M^2 =
        # sum(d^2 / inv_mass): the preconditioned dynamics then give every
        # coordinate unit frequency, so the criterion's optimum is
        # mass-invariant and T stays sane when a mass window re-whitens the
        # geometry mid-warmup (with unwhitened distances the optimum jumps
        # by the largest scale and Adam strands T orders of magnitude high).
        # In this metric <x'-mu', v'>_M = (x'-mu') . p' exactly.
        mu0 = lax.pmean(state.position, common.CHAIN_AXIS_NAME)
        mu1 = lax.pmean(z_prop, common.CHAIN_AXIS_NAME)
        if dense:
            # ||d||_M^2 = ||L^{-1} d||^2 with Sigma = L L^T
            w1 = jax.scipy.linalg.solve_triangular(state.mchol,
                                                   z_prop - mu1, lower=True)
            w0 = jax.scipy.linalg.solve_triangular(state.mchol,
                                                   state.position - mu0,
                                                   lower=True)
            d_sq = jnp.sum(w1 * w1) - jnp.sum(w0 * w0)
        else:
            d_sq = jnp.sum((z_prop - mu1) ** 2 / inv_mass) \
                - jnp.sum((state.position - mu0) ** 2 / inv_mass)
        g_chain = alpha * d_sq * jnp.dot(z_prop - mu1, p_prop)
        # one overflowed trajectory must not poison the POOLED gradient for
        # every chain forever (0 * inf = NaN survives pmean and Adam):
        # divergent chains contribute zero, like TFP's ChEES
        g_chain = jnp.where(jnp.isfinite(g_chain), g_chain, 0.0)
        denom = jnp.maximum(lax.pmean(alpha, common.CHAIN_AXIS_NAME), 1e-4)
        # gradient wrt T; chain rule to log T multiplies by T — fold the
        # jitter's dt/dT = h in as the paper does
        g_T = lax.pmean(g_chain, common.CHAIN_AXIS_NAME) / denom * h
        g_logT = jnp.clip(g_T * T, -1e6, 1e6)   # guard overflow into Adam

        t_adam = state.draw_ind.astype(dtype) + 1.0
        m_new = 0.9 * state.adam_m + 0.1 * g_logT
        v_new = 0.999 * state.adam_v + 0.001 * g_logT**2
        m_hat = m_new / (1.0 - 0.9 ** t_adam)
        v_hat = v_new / (1.0 - 0.999 ** t_adam)
        log_T_new = state.log_T + adam_lr * m_hat / (jnp.sqrt(v_hat) + 1e-8)
        # keep T within sane bounds of the current step size
        log_T_new = jnp.clip(log_T_new, jnp.log(eps),
                             jnp.log(eps * max_steps))

        log_T_out = jnp.where(adapting, log_T_new, state.log_T)
        adam_m_out = jnp.where(adapting, m_new, state.adam_m)
        adam_v_out = jnp.where(adapting, v_new, state.adam_v)

        # step size: dual averaging on the pooled harmonic-mean acceptance
        accept_stat = lax.pmean(alpha, common.CHAIN_AXIS_NAME)
        da_new = adaptation.da_update(state.da, accept_stat, target)
        da = jax.tree_util.tree_map(
            lambda new, old: jnp.where(adapting, new, old), da_new, state.da)

        wv = state.wv
        mSigma, mchol, mm2 = state.mSigma, state.mchol, state.mm2
        if adapt_mass and not dense:
            wv, _ = adaptation.windowed_precond_step(
                wv, da, position, state.draw_ind, mass_cfg, reset_da=False)
        elif dense:
            wv, da, mSigma, mchol, mm2 = adaptation.windowed_dense_step(
                state.wv, da, mSigma, mchol, mm2,
                position, state.draw_ind, mass_cfg, reset_da=False)

        new_state = ChEESState(
            position=position, potential=pot_out, da=da,
            log_T=log_T_out, adam_m=adam_m_out, adam_v=adam_v_out,
            wv=wv, mSigma=mSigma, mchol=mchol, mm2=mm2,
            draw_ind=state.draw_ind + 1,
        )
        info = {
            "accepted": accepted,
            "accept_stat": alpha,
            "n_leap": steps,
            "trajectory_length": T,
            "step_size": eps,
        }
        return new_state, info

    def init(position):
        dtype = position.dtype
        dim = position.shape[0]
        eps0 = jnp.asarray(cfg.step_size, dtype)
        return ChEESState(
            position=position,
            potential=potential(position),
            da=adaptation.da_init(eps0),
            log_T=jnp.log(eps0 * cfg.init_leap_steps),
            adam_m=jnp.asarray(0.0, dtype),
            adam_v=jnp.asarray(0.0, dtype),
            wv=adaptation.wv_init(dim, dtype),
            mSigma=jnp.eye(dim, dtype=dtype) if dense else jnp.ones((1,), dtype),
            mchol=jnp.eye(dim, dtype=dtype) if dense else jnp.ones((1,), dtype),
            mm2=jnp.zeros((dim, dim), dtype) if dense else jnp.ones((1,), dtype),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    return init, step


def chees(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
          mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
          bounded_grad="reference", adapt_mass_matrix=False,
          thin=1, return_resume=False) -> SamplerResult:
    """Run ChEES-HMC (see module docstring). Requires ``n_chains`` >= ~16 —
    the trajectory-length criterion pools cross-chain expectations.

    Returns kept draws plus diagnostics: per-draw trajectory length, leap
    counts, step size, pooled accept statistic, and the adapted values.
    ``return_resume=True`` attaches ``diagnostics["resume"](key, n_keep)``
    — a warm continuation from the final kernel state (adapted step size /
    trajectory length / mass carry over); incompatible with
    ``checkpoint_dir``."""
    algo, s = resolve_settings(settings, "chees_settings", ChEESSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains, dtype)
    if prob.n_chains < 2:
        raise ValueError("chees needs n_chains >= 2 (cross-chain pooling); "
                         "use hmc/nuts for single-chain runs")
    from mcmc_tpu import integrators
    grad_fn = integrators.make_kick_grad(prob, bounded_grad)

    mass_cfg = None
    if adapt_mass_matrix:
        mass_cfg = adaptation.make_precond_cfg(
            s.n_burnin_draws, pooled=True, axis_name=common.CHAIN_AXIS_NAME)

    init, step = build_chees_kernel(prob.box_log_kernel, grad_fn, s,
                                    s.n_burnin_draws, adapt_mass_matrix,
                                    mass_cfg)
    state0 = jax.vmap(init, axis_name=common.CHAIN_AXIS_NAME)(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            key, state0, step, n_burnin, n_keep,
            collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin,
        )

        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        if "accepted" in infos:
            diagnostics = {
                "accept_stat": infos["accept_stat"],
                "n_leap": infos["n_leap"],
                "trajectory_length": infos["trajectory_length"],
                "step_size": infos["step_size"],
            }
        else:
            totals = infos["totals"]
            diagnostics = {
                "mean_accept_stat": jnp.asarray(totals["accept_stat"])
                / n_keep,
                "mean_n_leap": jnp.asarray(totals["n_leap"]) / n_keep,
            }
        diagnostics["adapted_step_size"] = jnp.exp(final_state.da.log_eps_bar)
        diagnostics["adapted_trajectory_length"] = jnp.exp(final_state.log_T)
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {k: (v[:, 0] if v.ndim == 2 else v[0])
                           for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
