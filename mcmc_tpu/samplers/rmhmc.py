"""Riemannian-manifold HMC with fixed-point generalized leapfrog.

Accelerator-native re-design of reference src/rmhmc.cpp:30-325. The user supplies a
pure ``metric_fn(params) -> (d, d)`` position-dependent metric G; the metric
derivative cube the reference requires by hand (``Cube_t* tensor_deriv_out``,
examples/eigen/rmhmc_normal.cpp:78-111) is obtained with :func:`jax.jacfwd`.

The generalized leapfrog follows the reference exactly
(src/rmhmc.cpp:199-238):

- ``n_fp_steps`` fixed-point iterations for the implicit momentum half-step
  and for the implicit position step that averages ``G^{-1}`` at the old and
  new positions;
- the Hamiltonian includes ``0.5 d log(2 pi) + 0.5 log|G|``
  (src/rmhmc.cpp:188-190) and acceptance is clamped ``min(0.01, .)``;
- momentum is refreshed as ``chol(G(theta)) @ xi`` (src/rmhmc.cpp:202).

Reference quirk reproduced deliberately:

- within a multi-step trajectory, the first half-kick and the position
  fixed-point use the tensor of the trajectory *start* (``inv_prev_tensor``
  is only updated on acceptance, src/rmhmc.cpp:213-228), while the final
  half-kick uses the fresh tensor at the new position (:232-237).

Deviation (bug fix): the reference's momentum update *adds*
``eps/2 * dH/dtheta`` (src/rmhmc.cpp:213-215: ``mntm_update_fn`` returns
``+eps * grad/2`` where ``grad`` is exactly ``dH/dtheta``, and the caller
adds it). Combined with the forward position drift this is not an
integrator of any Hamiltonian — energy diverges for ``n_leap_steps > 1``
and the chain freezes (the reference only survives at its default of one
leapfrog step, where the MH correction absorbs the error). Here the kick
subtracts, the standard Girolami-Calderhead generalized leapfrog.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import bounds as bounds_mod
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import RMHMCSettings
from mcmc_tpu.stats import LOG_2PI
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["rmhmc", "RMHMCState", "build_rmhmc_kernel"]


class RMHMCState(NamedTuple):
    position: jax.Array      # unconstrained coordinates
    potential: jax.Array     # U incl. 0.5 log|G| and the 2pi constant
    tensor: jax.Array        # G at position, (d, d)
    inv_tensor: jax.Array    # G^{-1}
    chol_tensor: jax.Array   # chol(G), for momentum refresh
    deriv: jax.Array         # dG/dtheta_i stacked on axis 0, (d, d, d)


def build_rmhmc_kernel(prob: common.Problem, metric_fn, cfg: RMHMCSettings):
    dim = prob.n_vals
    cons_term = 0.5 * dim * LOG_2PI
    eps = cfg.step_size

    def to_constrained(z):
        if prob.vals_bound:
            return bounds_mod.inv_transform(z, prob.codes, prob.lower_bounds,
                                            prob.upper_bounds)
        return z

    user_grad = jax.grad(prob.log_kernel)
    metric_jac = jax.jacfwd(metric_fn)

    def box_tensor(z):
        """G and dG at the constrained point (reference src/rmhmc.cpp:152-165:
        the metric and its derivatives are the user's, evaluated at x — no
        Jacobian chaining)."""
        x = to_constrained(z)
        g = metric_fn(x)
        dg = jnp.moveaxis(metric_jac(x), -1, 0)  # (i, a, b) = dG_ab/dx_i
        return g, dg

    def box_tensor_only(z):
        return metric_fn(to_constrained(z))

    def potential_at(z, tensor):
        u = cons_term - prob.box_log_kernel(z) \
            + 0.5 * jnp.linalg.slogdet(tensor)[1]
        return u

    def mntm_update(z, p, inv_tensor, deriv):
        """-eps/2 * (J *) dH/dtheta (reference src/rmhmc.cpp:100-148, with
        the sign corrected — see module docstring)."""
        x = to_constrained(z)
        grad_x = user_grad(x)
        tmp = jnp.einsum("ab,ibc->iac", inv_tensor, deriv)     # G^{-1} dG_i
        trace = jnp.einsum("iaa->i", tmp)
        w = inv_tensor @ p
        quad = jnp.einsum("a,iab,b->i", p, tmp, w)
        grad_vec = -grad_x + 0.5 * (trace - quad)
        if prob.vals_bound:
            jac = bounds_mod.inv_jacobian_diag(z, prob.codes, prob.lower_bounds,
                                               prob.upper_bounds)
            grad_vec = jac * grad_vec
        return -0.5 * eps * grad_vec

    def init(position):
        tensor, deriv = box_tensor(position)
        inv_tensor = jnp.linalg.inv(tensor)
        return RMHMCState(
            position=position,
            potential=potential_at(position, tensor),
            tensor=tensor,
            inv_tensor=inv_tensor,
            chol_tensor=jnp.linalg.cholesky(tensor),
            deriv=deriv,
        )

    def step(key, state: RMHMCState):
        dtype = state.position.dtype
        k_mom, k_accept = jax.random.split(key)
        noise = jax.random.normal(k_mom, (dim,), dtype)
        momentum = state.chol_tensor @ noise
        prev_K = 0.5 * momentum @ (state.inv_tensor @ momentum)

        def leap_step(carry, _):
            z, p = carry
            # implicit momentum half-step: n_fp fixed-point iterations using
            # the trajectory-start tensor (reference quirk, see module doc)
            def mom_fp(pp, _):
                return p + mntm_update(z, pp, state.inv_tensor, state.deriv), None
            p_new, _ = lax.scan(mom_fp, p, None, length=cfg.n_fp_steps)

            # implicit position step averaging inv-tensors old/new
            def pos_fp(zz, _):
                inv_new = jnp.linalg.inv(box_tensor_only(zz))
                return z + 0.5 * eps * (state.inv_tensor + inv_new) @ p_new, None
            z_new, _ = lax.scan(pos_fp, z, None, length=cfg.n_fp_steps)

            # final explicit momentum half-step with the fresh tensor
            tensor_new, deriv_new = box_tensor(z_new)
            inv_new = jnp.linalg.inv(tensor_new)
            p_final = p_new + mntm_update(z_new, p_new, inv_new, deriv_new)
            return (z_new, p_final), None

        (new_z, new_p), _ = lax.scan(
            leap_step, (state.position, momentum), None, length=cfg.n_leap_steps
        )

        new_tensor, new_deriv = box_tensor(new_z)
        new_inv = jnp.linalg.inv(new_tensor)

        prop_U = potential_at(new_z, new_tensor)
        prop_U = jnp.where(jnp.isfinite(prop_U), prop_U, jnp.inf)
        prop_K = 0.5 * new_p @ (new_inv @ new_p)

        comp = jnp.minimum(0.01, -(prop_U + prop_K) + (state.potential + prev_K))
        u = jax.random.uniform(k_accept, dtype=dtype)
        accepted = u < jnp.exp(comp)

        def pick(a, b):
            return jnp.where(accepted, a, b)

        new_state = RMHMCState(
            position=pick(new_z, state.position),
            potential=pick(prop_U, state.potential),
            tensor=pick(new_tensor, state.tensor),
            inv_tensor=pick(new_inv, state.inv_tensor),
            chol_tensor=pick(jnp.linalg.cholesky(new_tensor), state.chol_tensor),
            deriv=pick(new_deriv, state.deriv),
        )
        return new_state, {"accepted": accepted}

    return init, step


def rmhmc(initial_vals, log_kernel, metric_fn, settings=None, *, n_chains=None,
          key=None, mesh=None, checkpoint_dir=None, checkpoint_every=500,
          dtype=None, thin=1, return_resume=False) -> SamplerResult:
    """Run RM-HMC. ``metric_fn(params) -> (d, d)`` SPD metric in constrained
    space; derivatives via jax.jacfwd replace the reference's hand-coded
    tensor cube (reference src/rmhmc.cpp entry at :281-303).
    ``return_resume=True`` attaches ``diagnostics["resume"](key, n_keep)``
    — a warm continuation from the final kernel state; incompatible with
    ``checkpoint_dir``."""
    algo, s = resolve_settings(settings, "rmhmc_settings", RMHMCSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains, dtype)
    init, step = build_rmhmc_kernel(prob, metric_fn, s)
    state0 = jax.vmap(init)(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            key, state0, step, n_burnin, n_keep,
            collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin,
        )

        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
        diagnostics = {"thin": int(thin)} if thin > 1 else {}
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
