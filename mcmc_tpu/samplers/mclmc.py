"""Microcanonical Langevin Monte Carlo — unadjusted (MCLMC) and
Metropolis-adjusted (MAMS).

No reference analog — these are the framework's highest-throughput
accelerator-native samplers, built on the *isokinetic* integrator of
Ver Steeg & Galstyan's ESH dynamics as used by Robnik, De Luca, Silverstein
& Seljak (2022, arXiv:2212.08549, "Microcanonical Hamiltonian Monte Carlo")
and Robnik & Seljak's Metropolis-adjusted variant (2023-24). Where HMC
resamples a d-dimensional Gaussian momentum every trajectory and pays an
accept/reject, MCLMC moves a *unit-speed* velocity on the (d-1)-sphere:

    dx/dt = u,        du/dt = P(u) grad(log p)(x) / (d-1),   P(u) = I - uu^T

whose unique stationary distribution on {|u|=1} marginalizes to the target
p(x). Discretized with the velocity-Verlet splitting below, every step costs
ONE gradient and every step is a draw — there is no tree, no accept/reject,
and the batch is perfectly lockstep under ``vmap`` (the same property that
lets ChEES outrun NUTS on wide batches, taken one step further). The price of the
unadjusted chain is an O(step_size^2) stationary bias, controlled by tuning
the step size so the per-dimension squared energy error per step
E[dE^2]/d stays at ``desired_energy_var`` (5e-4 default, the Robnik et al.
operating point — bias well below Monte-Carlo error at practical ESS).

Ergodicity comes from the Langevin part: a partial velocity refresh
``u <- (u + nu z)/|u + nu z|``, ``nu = sqrt(expm1(2 eps/L)/d)``, every step —
``L`` is the momentum-decoherence length, the sampler's one scale parameter.

**Tuning is cross-chain** (the large vmapped batch is the resource):

- step size: the pooled energy-error statistic ``exp(-dE^2 / (2 d sigma^2))``
  is driven to its target fixed point by the shared dual-averaging machinery
  (`adaptation.da_update`) — at the fixed point E[dE^2]/d equals
  ``desired_energy_var``;
- ``L``: set to ``l_factor * sqrt(trace Cov[x])`` (the Robnik et al. stage-1
  heuristic — for a standard Gaussian this is sqrt(d), the distance a
  unit-speed trajectory needs to decorrelate one coordinate), with the
  covariance trace estimated from the *instantaneous cross-chain variance*,
  EWMA-smoothed; no per-chain autocorrelation pass needed;
- optional diagonal preconditioning (``adapt_mass=True``): the same pooled
  variances whiten the dynamics (position steps and gradients scaled by
  sqrt(var)), after which the L heuristic reduces to ``l_factor * sqrt(d)``.

**MAMS** (``mams``) makes the chain exact: full velocity refresh, then a
jittered isokinetic trajectory of shared length (Halton-jittered around the
adapted ``L``, exactly the ChEES lockstep trick), accepted with probability
``min(1, exp(-dE))`` where ``dE`` is the accumulated microcanonical energy
error — the isokinetic analog of the Hamiltonian MH test (the
``(d-1) log r`` velocity-normalization terms play the role of kinetic
energy). Step size is dual-averaged to ``target_accept_rate`` 0.9 (isokinetic
energy errors are lighter-tailed than Hamiltonian ones, so the optimum sits
higher than HMC's 0.65).

Both samplers require ``dim >= 2`` (the isokinetic projector divides by
d-1) and ``n_chains >= 2`` (tuning pools cross-chain statistics). Both
compose with bounds (the box log-kernel + exact gradients), ``mesh``
sharding, ``thin``, ``checkpoint_dir``, and ``return_resume``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import adaptation
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import MCLMCSettings, MAMSSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu.samplers.chees import _vdc_base2

__all__ = ["mclmc", "mams", "MCLMCState", "MAMSState",
           "isokinetic_velocity_verlet", "partial_velocity_refresh"]

import math

_TINY = 1e-37
# the dual-averaging fixed point for the energy statistic exp(-varE/(2 s^2)):
# stat == target exactly when E[dE^2]/d == desired_energy_var
_ENERGY_STAT_TARGET = math.exp(-0.5)


def _iso_momentum_update(u, g, eps):
    """Exact isokinetic velocity update for a frozen gradient ``g`` over time
    ``eps``: the closed-form flow of du/dt = P(u) g / (d-1) on the unit
    sphere (ESH dynamics), in the numerically stable zeta = exp(-delta)
    form. Returns ``(u_new, kinetic_change)`` where ``kinetic_change`` is
    the (d-1) log r weight this update contributes to the microcanonical
    energy error."""
    dim = u.shape[0]
    g_norm = jnp.sqrt(jnp.sum(g * g))
    e = g / jnp.maximum(g_norm, _TINY)
    ue = jnp.dot(u, e)
    delta = eps * g_norm / (dim - 1)
    zeta = jnp.exp(-delta)
    uu = e * (1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)) + 2.0 * zeta * u
    uu_norm = jnp.sqrt(jnp.sum(uu * uu))
    u_new = uu / jnp.maximum(uu_norm, _TINY)
    # log(cosh(delta) + ue*sinh(delta)), stable for large delta
    delta_r = delta - jnp.log(2.0) + jnp.log(
        jnp.maximum((1.0 + ue) + (1.0 - ue) * zeta * zeta, _TINY))
    return u_new, (dim - 1) * delta_r


def isokinetic_velocity_verlet(value_and_grad_fn, sqrt_diag):
    """One velocity-Verlet step of the isokinetic dynamics, preconditioned by
    a diagonal ``sqrt_diag`` (positions move ``eps * sqrt_diag * u``;
    gradients enter scaled by ``sqrt_diag`` — i.e. the dynamics run in
    whitened coordinates). Returns
    ``step(eps, x, u, logp, g) -> (x', u', logp', g', dE)`` with ``dE`` the
    microcanonical energy change of the step (zero under exact flow).
    One gradient evaluation per step (the boundary gradient is carried)."""

    def step(eps, x, u, logp, g):
        u1, k1 = _iso_momentum_update(u, sqrt_diag * g, 0.5 * eps)
        x1 = x + eps * (sqrt_diag * u1)
        logp1, g1 = value_and_grad_fn(x1)
        u2, k2 = _iso_momentum_update(u1, sqrt_diag * g1, 0.5 * eps)
        d_energy = (k1 + k2) - (logp1 - logp)
        return x1, u2, logp1, g1, d_energy

    return step


# McLachlan & Atela's minimal-norm second-order coefficient: the B-A-B-A-B
# splitting with this lambda minimizes the third-order error norm — the
# energy-error constant is ~20x below velocity Verlet's, so the tuned step
# size grows more than enough to pay for the second gradient per step.
_MN_LAMBDA = 0.1931833275037836


def isokinetic_mclachlan(value_and_grad_fn, sqrt_diag):
    """One minimal-norm (McLachlan) second-order step of the isokinetic
    dynamics: u(lam*eps) x(eps/2) u((1-2lam)*eps) x(eps/2) u(lam*eps) —
    two gradient evaluations per step (boundary gradient carried), much
    smaller energy-error constant than velocity Verlet; the default
    integrator of the MCLMC reference implementations. Same signature as
    :func:`isokinetic_velocity_verlet`."""

    def step(eps, x, u, logp, g):
        u1, k1 = _iso_momentum_update(u, sqrt_diag * g, _MN_LAMBDA * eps)
        x1 = x + 0.5 * eps * (sqrt_diag * u1)
        _, g1 = value_and_grad_fn(x1)
        u2, k2 = _iso_momentum_update(u1, sqrt_diag * g1,
                                      (1.0 - 2.0 * _MN_LAMBDA) * eps)
        x2 = x1 + 0.5 * eps * (sqrt_diag * u2)
        logp2, g2 = value_and_grad_fn(x2)
        u3, k3 = _iso_momentum_update(u2, sqrt_diag * g2, _MN_LAMBDA * eps)
        d_energy = (k1 + k2 + k3) - (logp2 - logp)
        return x2, u3, logp2, g2, d_energy

    return step


_INTEGRATORS = {"velocity_verlet": isokinetic_velocity_verlet,
                "mclachlan": isokinetic_mclachlan}


def _get_integrator(name):
    try:
        return _INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"integrator must be one of {sorted(_INTEGRATORS)}, got "
            f"{name!r}") from None


def partial_velocity_refresh(key, u, eps, L):
    """Langevin partial refresh: ``u <- (u + nu z)/|u + nu z|`` with
    ``nu = sqrt(expm1(2 eps / L) / d)`` — the exact OU-on-the-sphere weight
    so that the velocity decorrelates over distance ``L``."""
    dim = u.shape[0]
    nu = jnp.sqrt(jnp.expm1(2.0 * eps / L) / dim).astype(u.dtype)
    z = jax.random.normal(key, (dim,), u.dtype)
    w = u + nu * z
    return w / jnp.maximum(jnp.sqrt(jnp.sum(w * w)), _TINY)


def _random_unit(key, dim, dtype):
    z = jax.random.normal(key, (dim,), dtype)
    return z / jnp.maximum(jnp.sqrt(jnp.sum(z * z)), _TINY)


def _pooled_var_update(var_ema, position, rate, adapting):
    """EWMA of the instantaneous cross-chain per-dimension variance —
    pooled over the named chain axis, so every chain carries the same
    estimate (a psum collective when chains span a mesh)."""
    m1 = lax.pmean(position, common.CHAIN_AXIS_NAME)
    m2 = lax.pmean(position * position, common.CHAIN_AXIS_NAME)
    var_inst = jnp.maximum(m2 - m1 * m1, 0.0)
    new = var_ema + rate * (var_inst - var_ema)
    return jnp.where(adapting, new, var_ema)


def _auto_L(var_ema, sqrt_diag, l_factor, eps):
    """Robnik et al. stage-1 heuristic in the whitened metric:
    ``l_factor * sqrt(sum var_i / diag_i)``; floored at ``2 eps`` so the
    refresh never degenerates."""
    whitened = var_ema / jnp.maximum(sqrt_diag * sqrt_diag, _TINY)
    return jnp.maximum(l_factor * jnp.sqrt(jnp.sum(whitened)), 2.0 * eps)


class MCLMCState(NamedTuple):
    position: jax.Array
    velocity: jax.Array       # unit norm
    logdens: jax.Array        # box_log_kernel(position)
    grad: jax.Array           # its gradient (carried across steps)
    da: adaptation.DualAveraging
    log_L: jax.Array
    var_ema: jax.Array        # pooled cross-chain variance, EWMA
    sqrt_diag: jax.Array      # diagonal preconditioner (ones if disabled)
    draw_ind: jax.Array


class MAMSState(NamedTuple):
    position: jax.Array
    logdens: jax.Array
    grad: jax.Array
    da: adaptation.DualAveraging
    log_L: jax.Array
    var_ema: jax.Array
    sqrt_diag: jax.Array
    draw_ind: jax.Array


def _finite_value_and_grad(box_log_kernel):
    vg = jax.value_and_grad(box_log_kernel)

    def fn(z):
        v, g = vg(z)
        v = jnp.where(jnp.isfinite(v), v, -jnp.inf)
        return v, g

    return fn


def build_mclmc_kernel(box_log_kernel, cfg: MCLMCSettings, n_adapt: int,
                       adapt_mass: bool = False):
    """Batch-pooled unadjusted MCLMC transition ``(key, state) -> (state,
    info)``. Must run under ``vmap``/``shard_map`` with the chain axis named
    ``common.CHAIN_AXIS_NAME`` — step-size/L tuning pools over it."""
    desired = float(cfg.desired_energy_var)
    l_factor = float(cfg.l_factor)
    rate = float(cfg.variance_ema_rate)
    auto_L = float(cfg.L) == 0.0
    vg = _finite_value_and_grad(box_log_kernel)
    make_integrator = _get_integrator(cfg.integrator)

    def step(key, state: MCLMCState):
        dim = state.position.shape[0]
        k_refresh = key

        adapting = state.draw_ind < n_adapt
        eps = jnp.exp(jnp.where(adapting, state.da.log_eps,
                                state.da.log_eps_bar))
        L = jnp.exp(state.log_L)
        vv = make_integrator(vg, state.sqrt_diag)

        x1, u1, logp1, g1, d_energy = vv(
            eps, state.position, state.velocity, state.logdens, state.grad)

        # a non-finite step (outside the support, overflowed gradient) must
        # not kill an unadjusted chain: bounce — keep the position, flip the
        # velocity (the deterministic reflection of the underlying flow)
        ok = jnp.isfinite(logp1) & jnp.all(jnp.isfinite(x1)) \
            & jnp.all(jnp.isfinite(u1))
        position = jnp.where(ok, x1, state.position)
        velocity = jnp.where(ok, u1, -state.velocity)
        logdens = jnp.where(ok, logp1, state.logdens)
        grad = jnp.where(ok, g1, state.grad)

        velocity = partial_velocity_refresh(k_refresh, velocity, eps, L)

        # --- step-size tuning: pooled per-dim energy-error variance ---
        de2 = jnp.where(ok & jnp.isfinite(d_energy), d_energy * d_energy,
                        jnp.asarray(10.0 * desired * dim,
                                    state.position.dtype))
        var_e = lax.pmean(de2, common.CHAIN_AXIS_NAME) / dim
        energy_stat = jnp.exp(-0.5 * var_e / desired)
        da_new = adaptation.da_update(state.da, energy_stat,
                                      _ENERGY_STAT_TARGET)
        da = jax.tree_util.tree_map(
            lambda new, old: jnp.where(adapting, new, old), da_new, state.da)

        var_ema = _pooled_var_update(state.var_ema, position, rate, adapting)
        sqrt_diag = state.sqrt_diag
        if adapt_mass:
            sqrt_diag = jnp.where(adapting,
                                  jnp.sqrt(jnp.maximum(var_ema, _TINY)),
                                  state.sqrt_diag)
        if auto_L:
            log_L = jnp.where(
                adapting,
                jnp.log(_auto_L(var_ema, sqrt_diag, l_factor, eps)),
                state.log_L)
        else:
            log_L = state.log_L

        new_state = MCLMCState(
            position=position, velocity=velocity, logdens=logdens, grad=grad,
            da=da, log_L=log_L, var_ema=var_ema, sqrt_diag=sqrt_diag,
            draw_ind=state.draw_ind + 1,
        )
        info = {
            "accepted": ok,
            "energy_change": jnp.where(jnp.isfinite(d_energy), d_energy, 0.0),
            "step_size": eps,
            "L": L,
        }
        return new_state, info

    def init(key, position, L0, eps0):
        dtype = position.dtype
        dim = position.shape[0]
        logp, g = vg(position)
        return MCLMCState(
            position=position,
            velocity=_random_unit(key, dim, dtype),
            logdens=logp, grad=g,
            da=adaptation.da_init(jnp.asarray(eps0, dtype)),
            log_L=jnp.log(jnp.asarray(L0, dtype)),
            var_ema=jnp.ones((dim,), dtype),
            sqrt_diag=jnp.ones((dim,), dtype),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    return init, step


def build_mams_kernel(box_log_kernel, cfg: MAMSSettings, n_adapt: int,
                      adapt_mass: bool = False):
    """Batch-pooled Metropolis-adjusted microcanonical transition. Full
    velocity refresh + shared Halton-jittered isokinetic trajectory +
    accept on the accumulated energy error (exact stationary law)."""
    target = float(cfg.target_accept_rate)
    max_steps = int(cfg.max_leap_steps)
    l_factor = float(cfg.l_factor)
    rate = float(cfg.variance_ema_rate)
    auto_L = float(cfg.L) == 0.0
    vg = _finite_value_and_grad(box_log_kernel)
    make_integrator = _get_integrator(cfg.integrator)

    def step(key, state: MAMSState):
        dtype = state.position.dtype
        dim = state.position.shape[0]
        k_mom, k_acc = jax.random.split(key)

        adapting = state.draw_ind < n_adapt
        eps = jnp.exp(jnp.where(adapting, state.da.log_eps,
                                state.da.log_eps_bar))
        L = jnp.exp(state.log_L)
        vv = make_integrator(vg, state.sqrt_diag)

        # shared jitter (same Halton trick as ChEES): t in [L/2, 3L/2],
        # mean L — uniform-from-zero jitter wastes draws on tiny trajectories
        # under MH, where every draw pays a refresh + accept
        h = _vdc_base2(state.draw_ind + 1).astype(dtype)
        t_len = (0.5 + h) * L
        steps = jnp.clip(jnp.round(t_len / eps).astype(jnp.int32),
                         1, max_steps)

        u0 = _random_unit(k_mom, dim, dtype)

        def body(c):
            i, x, u, logp, g, acc = c
            x, u, logp, g, de = vv(eps, x, u, logp, g)
            return i + 1, x, u, logp, g, acc + de

        _, x_prop, _, logp_prop, g_prop, d_energy = lax.while_loop(
            lambda c: c[0] < steps, body,
            (jnp.asarray(0, jnp.int32), state.position, u0,
             state.logdens, state.grad, jnp.asarray(0.0, dtype)),
        )

        log_alpha = jnp.minimum(0.0, -d_energy)
        alpha = jnp.where(jnp.isnan(log_alpha), 0.0, jnp.exp(log_alpha))
        accepted = jax.random.uniform(k_acc, dtype=dtype) < alpha

        position = jnp.where(accepted, x_prop, state.position)
        logdens = jnp.where(accepted, logp_prop, state.logdens)
        grad = jnp.where(accepted, g_prop, state.grad)

        accept_stat = lax.pmean(alpha, common.CHAIN_AXIS_NAME)
        da_new = adaptation.da_update(state.da, accept_stat, target)
        da = jax.tree_util.tree_map(
            lambda new, old: jnp.where(adapting, new, old), da_new, state.da)

        var_ema = _pooled_var_update(state.var_ema, position, rate, adapting)
        sqrt_diag = state.sqrt_diag
        if adapt_mass:
            sqrt_diag = jnp.where(adapting,
                                  jnp.sqrt(jnp.maximum(var_ema, _TINY)),
                                  state.sqrt_diag)
        if auto_L:
            log_L = jnp.where(
                adapting,
                jnp.log(_auto_L(var_ema, sqrt_diag, l_factor, eps)),
                state.log_L)
        else:
            log_L = state.log_L

        new_state = MAMSState(
            position=position, logdens=logdens, grad=grad, da=da,
            log_L=log_L, var_ema=var_ema, sqrt_diag=sqrt_diag,
            draw_ind=state.draw_ind + 1,
        )
        info = {
            "accepted": accepted,
            "accept_stat": alpha,
            "n_leap": steps,
            "step_size": eps,
            "trajectory_length": L,
        }
        return new_state, info

    def init(key, position, L0, eps0):
        del key  # velocity is refreshed every draw
        dtype = position.dtype
        dim = position.shape[0]
        logp, g = vg(position)
        return MAMSState(
            position=position, logdens=logp, grad=g,
            da=adaptation.da_init(jnp.asarray(eps0, dtype)),
            log_L=jnp.log(jnp.asarray(L0, dtype)),
            var_ema=jnp.ones((dim,), dtype),
            sqrt_diag=jnp.ones((dim,), dtype),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    return init, step


def _resolve_scales(cfg, dim, default_eps_frac):
    """(L0, eps0) with 0.0-means-auto defaults: L0 = sqrt(dim) (the whitened
    standard-Gaussian value the adaptation then corrects), eps0 a fixed
    fraction of L0."""
    L0 = float(cfg.L) if float(cfg.L) > 0.0 else float(dim) ** 0.5
    eps0 = float(cfg.step_size) if float(cfg.step_size) > 0.0 \
        else default_eps_frac * L0
    return L0, eps0


def _run_common(prob, init, step, L0, eps0, key, s, mesh, checkpoint_dir,
                checkpoint_every, thin, return_resume, extra_diags):
    """Shared run-and-assemble tail for mclmc/mams."""
    key, k_init = jax.random.split(key)
    init_keys = jax.random.split(k_init, prob.n_chains)
    state0 = jax.vmap(lambda k, x: init(k, x, L0, eps0),
                      axis_name=common.CHAIN_AXIS_NAME)(
                          init_keys, prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            key, state0, step, n_burnin, n_keep,
            collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin,
        )
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = extra_diags(final_state, infos, n_keep)
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {k: (v[:, 0] if getattr(v, "ndim", 0) == 2
                               else (v[0] if getattr(v, "ndim", 0) == 1
                                     else v))
                           for k, v in diagnostics.items()}
        if thin > 1:
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result


def _check_problem(prob, name):
    if prob.n_vals < 2:
        raise ValueError(f"{name} needs dim >= 2 (the isokinetic dynamics "
                         "divide by dim-1); use mala/slice for 1-d targets")
    if prob.n_chains < 2:
        raise ValueError(f"{name} needs n_chains >= 2 (step-size and L "
                         "tuning pool cross-chain statistics)")


def mclmc(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
          mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
          adapt_mass=False, thin=1, return_resume=False) -> SamplerResult:
    """Unadjusted Microcanonical Langevin Monte Carlo (module docstring).

    One gradient per draw, no accept/reject, perfectly lockstep across the
    chain batch. The stationary law carries an O(step_size^2) bias held at
    the ``desired_energy_var`` operating point by the burn-in tuning; for
    bit-exact stationarity use :func:`mams`. ``adapt_mass=True`` turns on
    diagonal preconditioning from the pooled cross-chain variances.

    Diagnostics: per-draw ``energy_change`` (its pooled square per dimension
    is the bias control variable), ``step_size``, ``L``, plus the adapted
    values; ``accepted`` counts *finite* steps (a non-finite step bounces
    and reports False — all-True is the healthy state).
    """
    algo, s = resolve_settings(settings, "mclmc_settings", MCLMCSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype)
    _check_problem(prob, "mclmc")
    L0, eps0 = _resolve_scales(s, prob.n_vals, default_eps_frac=0.1)
    init, step = build_mclmc_kernel(prob.box_log_kernel, s, s.n_burnin_draws,
                                    adapt_mass)

    def extra_diags(final_state, infos, n_keep):
        if "energy_change" in infos:
            diagnostics = {
                "energy_change": infos["energy_change"],
                "step_size": infos["step_size"],
                "L": infos["L"],
            }
        else:
            totals = infos["totals"]
            diagnostics = {
                "mean_energy_change": jnp.asarray(totals["energy_change"])
                / n_keep,
            }
        diagnostics["adapted_step_size"] = jnp.exp(
            final_state.da.log_eps_bar[0])
        diagnostics["adapted_L"] = jnp.exp(final_state.log_L[0])
        return diagnostics

    return _run_common(prob, init, step, L0, eps0, key, s, mesh,
                       checkpoint_dir, checkpoint_every, thin, return_resume,
                       extra_diags)


def mams(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
         mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
         adapt_mass=False, thin=1, return_resume=False) -> SamplerResult:
    """Metropolis-adjusted microcanonical sampler (module docstring).

    Exact stationary distribution: full velocity refresh + a shared
    Halton-jittered isokinetic trajectory per draw, accepted on the
    accumulated microcanonical energy error. The lockstep cost profile of
    ChEES with the isokinetic integrator's longer stable step sizes.
    """
    algo, s = resolve_settings(settings, "mams_settings", MAMSSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype)
    _check_problem(prob, "mams")
    L0, eps0 = _resolve_scales(s, prob.n_vals, default_eps_frac=0.05)
    init, step = build_mams_kernel(prob.box_log_kernel, s, s.n_burnin_draws,
                                   adapt_mass)

    def extra_diags(final_state, infos, n_keep):
        if "accepted" in infos and "accept_stat" in infos:
            diagnostics = {
                "accept_stat": infos["accept_stat"],
                "n_leap": infos["n_leap"],
                "step_size": infos["step_size"],
                "trajectory_length": infos["trajectory_length"],
            }
        else:
            totals = infos["totals"]
            diagnostics = {
                "mean_accept_stat": jnp.asarray(totals["accept_stat"])
                / n_keep,
                "mean_n_leap": jnp.asarray(totals["n_leap"]) / n_keep,
            }
        diagnostics["adapted_step_size"] = jnp.exp(
            final_state.da.log_eps_bar[0])
        diagnostics["adapted_L"] = jnp.exp(final_state.log_L[0])
        return diagnostics

    return _run_common(prob, init, step, L0, eps0, key, s, mesh,
                       checkpoint_dir, checkpoint_every, thin, return_resume,
                       extra_diags)
