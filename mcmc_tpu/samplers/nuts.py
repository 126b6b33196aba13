"""No-U-Turn sampler with dual-averaging step-size adaptation.

Accelerator-native re-design of reference src/nuts.cpp:30-359 +
include/mcmc/nuts.ipp:30-241. The reference's *recursive* tree builder
(nuts.ipp:99-241) cannot compile under XLA, so the tree is rebuilt in
masked, fixed-structure iterative form (SURVEY.md §7 step 4):

- The outer doubling loop is a ``lax.while_loop`` over tree depth
  (src/nuts.cpp:227-290).
- Each subtree of ``2^depth`` leapfrog steps is an inner ``lax.while_loop``
  over leaves with **progressive U-turn checks** via a checkpoint buffer of
  ``max_tree_depth + 1`` boundary states: leaf ``j`` is stored at slot
  ``ctz(j)`` (slot ``depth`` for ``j = 0``); when leaf ``i`` completes a
  size-``2^l`` sub-subtree (``(i+1) % 2^l == 0``) it is checked against the
  stored leaf ``i+1-2^l``. This visits exactly the internal-node pairs the
  reference's recursion checks (nuts.ipp:226-229).
- The in-subtree proposal uses reservoir sampling (take leaf ``i`` with
  probability ``valid_i / n_so_far``), which is distributionally identical
  to the reference's pairwise ``n''/(n'+n'')`` swaps (nuts.ipp:213-218) since
  every valid leaf ends up equally likely.

**Deviation (default ``tree_variant="endpoint"``):** the reference's outer
doubling loop restarts every subtree from the *current draw* with the
draw's *initial momentum* instead of extending the trajectory from the
tree's endpoint (src/nuts.cpp:242-255 passes ``prev_draw``/``mntm_vec``
every iteration; Hoffman-Gelman Algorithm 6 extends from
``theta^-/r^-`` or ``theta^+/r^+``). That breaks the reversibility of the
doubling construction and measurably biases asymmetric posteriors: on the
eight-schools model (half-Cauchy tau) the reference-shaped tree gives
E[tau] ~ 4.5 where exact 2-d quadrature gives 3.59 (and long RWMH runs
3.49); the endpoint variant is unbiased. The default therefore implements
Algorithm 6 correctly; pass ``tree_variant="reference"`` for bug-level
parity with the C++.

Reference quirks reproduced deliberately (verified against the C++ source):

- The initial step-size heuristic (nuts.ipp:30-93) can only *double*
  epsilon: its loop condition and its ``a`` update test the same inequality,
  so the halving branch is unreachable; the leapfrog also continues from the
  last position instead of restarting.
- Dual averaging consumes ``alpha/n_alpha`` of the **last** subtree only
  (outer loop overwrites them per doubling), and adaptation runs for
  ``min(n_adapt_draws, n_total)`` draws with no burn-in guard
  (src/nuts.cpp:54,294-302).
- Divergence guard ``Delta_max = 1000`` (nuts.ipp:124).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu import integrators
from mcmc_tpu import adaptation
from mcmc_tpu.adaptation import window_schedule
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import NUTSSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["nuts", "NUTSState", "build_nuts_kernel", "make_subtree_builder"]

_MAX_TUNING_PAR = 1000.0  # Delta_max, reference nuts.ipp:124
_LOG_HALF = math.log(0.5)


class NUTSState(NamedTuple):
    position: jax.Array
    potential: jax.Array     # U = -box_log_kernel(position)
    step_size: jax.Array
    epsilon_bar: jax.Array
    h_val: jax.Array
    mu_val: jax.Array        # log(10 * eps_0); re-centered at window ends
    draw_ind: jax.Array      # global draw counter driving adaptation
    adapt_t0: jax.Array      # draw index of the last mass-window end
    inv_mass: jax.Array      # inverse mass: (d,) diagonal or (d, d) dense
    mass_chol: jax.Array     # chol of inv_mass (dense mode; (1,) otherwise)
    w_count: jax.Array       # Welford accumulators for the current window
    w_mean: jax.Array
    w_m2: jax.Array          # (d,) diagonal or (d, d) dense
    depth_hist: jax.Array    # (max_depth + 1,) warmup tree-depth counts
    depth_cap: jax.Array     # doubling budget for the sampling phase


def _ctz(x):
    """Count trailing zeros of a positive int32 (0 for odd x)."""
    return lax.population_count((~x) & (x - 1))


def make_subtree_builder(potential, kinetic, leapfrog1, max_depth,
                         multinomial=False):
    """Masked-iterative equivalent of the reference's recursive
    ``nuts_build_tree`` (nuts.ipp:99-241). Module-level so tests can verify
    tree equivalence against a direct recursion port
    (tests/test_nuts.py::test_subtree_matches_reference_recursion).

    ``potential(z)``, ``kinetic(r, inv_mass)``, ``leapfrog1(z, r, eps,
    inv_mass)`` are the Hamiltonian pieces; returns ``build_subtree``.

    ``multinomial=True`` replaces the slice-sampler leaf weights (the
    Hoffman-Gelman construction the reference uses) with Boltzmann weights
    ``w = exp(H0 - H)`` per leaf (Betancourt 2017, "A Conceptual
    Introduction to HMC" A.3 — what modern Stan runs): ``log_u`` then
    carries ``+H0`` (no slice variable) and the returned ``n`` is the
    accumulated float weight instead of a valid-leaf count.
    """

    def build_subtree(key, depth, v, z0, r0, eps, log_u, alpha_base, dim, dtype,
                      inv_mass=None):
        """One subtree of 2^depth leapfrog steps in direction v from (z0, r0).

        Returns a dict with the proposal (prop_z/prop_U), leaf count n, stop
        flag s, dual-averaging alpha/n_alpha, trajectory endpoint (z, r), and
        the divergence flag.
        """
        n_steps = lax.shift_left(jnp.asarray(1, jnp.int32), depth)
        ckpt_z = jnp.zeros((max_depth + 1, dim), dtype)
        ckpt_r = jnp.zeros((max_depth + 1, dim), dtype)

        def cond(c):
            return (c["i"] < n_steps) & (c["s"] == 1)

        def body(c):
            key, k_res = jax.random.split(c["key"])
            i = c["i"]
            z, r = leapfrog1(c["z"], c["r"], v * eps, inv_mass)
            U = potential(z)
            H = U + kinetic(r, inv_mass)

            if multinomial:
                # Boltzmann leaf weight w = exp(H0 - H); log_u carries +H0
                log_w = jnp.where(jnp.isnan(H), -jnp.inf, log_u - H)
                weight = jnp.exp(jnp.minimum(log_w, 80.0))
                diverged = ~(log_w > -_MAX_TUNING_PAR)
                n_new = c["n"] + weight
                take_prob_num = weight
            else:
                valid = (log_u <= -H).astype(jnp.int32)
                diverged = ~(log_u < _MAX_TUNING_PAR - H)
                n_new = c["n"] + valid
                take_prob_num = valid.astype(dtype)
            # NaN H (overflowed trajectory) must contribute alpha = 0, not
            # poison dual averaging: jnp.minimum(0, NaN) is NaN, whereas the
            # reference's std::min(0., NaN) returns 0 (C++ comparison
            # semantics, nuts.ipp:152) — zero is also the statistically
            # correct "rejected" value
            alpha_leaf = jnp.where(
                jnp.isnan(H), 0.0, jnp.exp(jnp.minimum(0.0, alpha_base - H))
            )

            # weighted-reservoir proposal: take with prob w_leaf / W_new
            zu = jax.random.uniform(k_res, dtype=dtype)
            take = zu * n_new.astype(dtype) < take_prob_num
            prop_z = jnp.where(take, z, c["prop_z"])
            prop_U = jnp.where(take, U, c["prop_U"])

            # checkpoint store: slot ctz(i) for even i > 0, slot `depth` for i == 0
            slot = jnp.where(i == 0, depth, _ctz(i))
            should_store = (i == 0) | (_ctz(i) > 0)
            ckpt_z = jnp.where(should_store, c["ckpt_z"].at[slot].set(z), c["ckpt_z"])
            ckpt_r = jnp.where(should_store, c["ckpt_r"].at[slot].set(r), c["ckpt_r"])

            # progressive U-turn checks at every completed sub-subtree level
            ok = jnp.asarray(True)
            for l in range(1, max_depth + 1):
                size = 1 << l
                complete = (((i + 1) & (size - 1)) == 0) & (l <= depth)
                j = i + 1 - size
                slot_j = jnp.where(j == 0, depth, _ctz(jnp.maximum(j, 1)))
                zj = ckpt_z[slot_j]
                rj = ckpt_r[slot_j]
                dvec = v * (z - zj)
                u_ok = (jnp.dot(dvec, rj) >= 0) & (jnp.dot(dvec, r) >= 0)
                ok = ok & (~complete | u_ok)

            s_new = jnp.where(diverged | ~ok, 0, c["s"]).astype(jnp.int32)

            return {
                "key": key, "i": i + 1, "z": z, "r": r,
                "prop_z": prop_z, "prop_U": prop_U,
                "n": n_new, "s": s_new,
                "alpha": c["alpha"] + alpha_leaf,
                "n_alpha": c["n_alpha"] + 1,
                "ckpt_z": ckpt_z, "ckpt_r": ckpt_r,
                "div": c["div"] | diverged,
            }

        n0 = jnp.asarray(0.0, dtype) if multinomial else jnp.asarray(0, jnp.int32)
        init = {
            "key": key, "i": jnp.asarray(0, jnp.int32), "z": z0, "r": r0,
            "prop_z": z0, "prop_U": jnp.asarray(jnp.inf, dtype),
            "n": n0, "s": jnp.asarray(1, jnp.int32),
            "alpha": jnp.asarray(0.0, dtype), "n_alpha": jnp.asarray(0, jnp.int32),
            "ckpt_z": ckpt_z, "ckpt_r": ckpt_r, "div": jnp.asarray(False),
        }
        out = lax.while_loop(cond, body, init)
        return out

    return build_subtree


def build_nuts_kernel(box_log_kernel, grad_fn, precond: common.SPD, cfg: NUTSSettings,
                      n_adapt: int, pooled_adaptation: bool = False,
                      adapt_mass_matrix=False, adapt_depth=False,
                      depth_quantile: float = 0.98,
                      tree_variant: str = "endpoint",
                      sample_method: str = "slice",
                      warmup_tree_depth=None):
    if tree_variant not in ("endpoint", "reference"):
        raise ValueError(f"tree_variant must be 'endpoint' or 'reference', "
                         f"got {tree_variant!r}")
    if sample_method not in ("slice", "multinomial"):
        raise ValueError(f"sample_method must be 'slice' or 'multinomial', "
                         f"got {sample_method!r}")
    multinomial = sample_method == "multinomial"
    if multinomial and tree_variant == "reference":
        raise ValueError("sample_method='multinomial' is a modern variant; "
                         "it does not combine with tree_variant='reference'")
    max_depth = int(cfg.max_tree_depth)
    # adapt_mass_matrix: False | "diag" (True) | "dense"
    mass_mode = {False: None, True: "diag"}.get(adapt_mass_matrix,
                                                adapt_mass_matrix)
    if mass_mode not in (None, "diag", "dense"):
        raise ValueError(f"adapt_mass_matrix must be False/True/'diag'/'dense', "
                         f"got {adapt_mass_matrix!r}")
    adapt_mass = mass_mode is not None
    mass_collect, mass_window_end = window_schedule(n_adapt) \
        if adapt_mass else (None, None)

    def potential(z):
        u = -box_log_kernel(z)
        return jnp.where(jnp.isfinite(u), u, jnp.inf)

    def kinetic(r, inv_mass=None):
        if mass_mode == "diag":
            return 0.5 * jnp.sum(r * r * inv_mass)
        if mass_mode == "dense":
            return 0.5 * r @ (inv_mass @ r)     # inv_mass = Sigma = M^{-1}
        return integrators.kinetic_energy(r, precond.inv_mv)

    def leapfrog1(z, r, eps, inv_mass=None):
        if mass_mode == "diag":
            inv_mv = lambda v: inv_mass * v
        elif mass_mode == "dense":
            inv_mv = lambda v: inv_mass @ v
        else:
            inv_mv = precond.inv_mv
        return integrators.leapfrog(grad_fn, inv_mv, eps, 1, z, r)

    def sample_momentum(noise, inv_mass=None, mass_chol=None):
        if mass_mode == "diag":
            # M = diag(1/inv_mass) => chol(M) = 1/sqrt(inv_mass)
            return noise * jax.lax.rsqrt(inv_mass)
        if mass_mode == "dense":
            # Sigma = L L^T, M = Sigma^{-1} => p = L^{-T} xi ~ N(0, M)
            return jax.scipy.linalg.solve_triangular(mass_chol.T, noise,
                                                     lower=False)
        return precond.sqrt_mv(noise)

    def find_initial_step_size(z0, r0, inv_mass=None):
        """Reference nuts.ipp:30-93 (doubling-only; see module docstring)."""
        dtype = z0.dtype
        H0 = potential(z0) + kinetic(r0, inv_mass)

        z, r = leapfrog1(z0, r0, jnp.asarray(1.0, dtype), inv_mass)
        dH = -(potential(z) + kinetic(r, inv_mass)) + H0

        def cond(c):
            eps, z, r, dH, it = c
            return (dH > _LOG_HALF) & (it < 64)

        def body(c):
            eps, z, r, dH, it = c
            eps = eps * 2.0
            z, r = leapfrog1(z, r, eps, inv_mass)
            dH = -(potential(z) + kinetic(r, inv_mass)) + H0
            return (eps, z, r, dH, it + 1)

        eps, _, _, _, _ = lax.while_loop(
            cond, body, (jnp.asarray(1.0, dtype), z, r, dH, jnp.asarray(0, jnp.int32))
        )
        return eps

    build_subtree = make_subtree_builder(potential, kinetic, leapfrog1,
                                         max_depth, multinomial)

    def init(key, position):
        dtype = position.dtype
        dim = position.shape[0]
        if mass_mode == "dense":
            inv_mass0 = jnp.eye(dim, dtype=dtype)
            chol0 = jnp.eye(dim, dtype=dtype)
            w_m2_0 = jnp.zeros((dim, dim), dtype)
        else:
            inv_mass0 = jnp.ones((dim,), dtype)
            chol0 = jnp.ones((1,), dtype)
            w_m2_0 = jnp.zeros((dim,), dtype)
        noise = jax.random.normal(key, position.shape, dtype)
        r0 = sample_momentum(noise, inv_mass0, chol0)
        eps0 = find_initial_step_size(position, r0, inv_mass0)
        if pooled_adaptation:
            # geometric mean across chains so the shared trajectory starts
            # from one common epsilon_0 / mu
            eps0 = jnp.exp(lax.pmean(jnp.log(eps0), common.CHAIN_AXIS_NAME))
        return NUTSState(
            depth_hist=jnp.zeros((max_depth + 1,), jnp.int32),
            depth_cap=jnp.asarray(max_depth, jnp.int32),
            position=position,
            potential=potential(position),
            step_size=eps0,
            epsilon_bar=jnp.asarray(cfg.step_size, dtype),
            h_val=jnp.asarray(0.0, dtype),
            mu_val=jnp.log(10.0 * eps0),
            draw_ind=jnp.asarray(0, jnp.int32),
            adapt_t0=jnp.asarray(0, jnp.int32),
            inv_mass=inv_mass0,
            mass_chol=chol0,
            w_count=jnp.asarray(0, jnp.int32),
            w_mean=jnp.zeros((dim,), dtype),
            w_m2=w_m2_0,
        )

    def step(key, state: NUTSState):
        dim = state.position.shape[0]
        dtype = state.position.dtype
        k_mom, k_slice, k_tree = jax.random.split(key, 3)

        noise = jax.random.normal(k_mom, (dim,), dtype)
        inv_mass = state.inv_mass
        r0 = sample_momentum(noise, inv_mass, state.mass_chol)
        prev_K = kinetic(r0, inv_mass)
        if multinomial:
            # no slice variable: log_u carries +H0 so leaves weight as
            # exp(log_u - H) = exp(H0 - H)
            log_u = state.potential + prev_K
        else:
            log_u = jnp.log(jax.random.uniform(k_slice, dtype=dtype)) \
                - state.potential - prev_K

        eps = state.step_size

        n_init = jnp.asarray(1.0, dtype) if multinomial \
            else jnp.asarray(1, jnp.int32)
        carry = {
            "key": k_tree,
            "depth": jnp.asarray(0, jnp.int32),
            "n": n_init,
            "s": jnp.asarray(1, jnp.int32),
            "draw": state.position, "U": state.potential,
            "pos_z": state.position, "neg_z": state.position,
            "pos_r": r0, "neg_r": r0,
            "alpha": jnp.asarray(0.0, dtype),
            "n_alpha": jnp.asarray(0, jnp.int32),
            "good": jnp.asarray(False), "div": jnp.asarray(False),
        }

        # depth budget: during warmup the full max_depth applies (and the
        # realized depths are histogrammed); after warmup the doubling loop
        # is capped at the learned budget — NUTS is a valid kernel at any
        # max depth, and under vmap every chain pays the slowest chain's
        # tree, so capping the rare deep trees is the straggler lever
        depth_limit = jnp.where(state.draw_ind < n_adapt, max_depth,
                                state.depth_cap) if adapt_depth else max_depth
        if warmup_tree_depth is not None:
            # early-warmup straggler lever: before the step size settles,
            # mis-adapted eps makes whole batches pay near-max-depth trees
            # (measured ~36x the settled per-draw cost on the flagship).
            # Cap the doubling budget for the FIRST half of warmup only —
            # NUTS is a valid kernel at any cap, and the depth histogram
            # (collected over the second half) never sees capped draws, so
            # the learned sampling budget is untouched.
            first_half = state.draw_ind < (n_adapt // 2)
            depth_limit = jnp.where(
                first_half,
                jnp.minimum(depth_limit, int(warmup_tree_depth)),
                depth_limit)

        def outer_cond(c):
            return (c["s"] == 1) & (c["depth"] < depth_limit)

        def outer_body(c):
            key, k_dir, k_acc, k_sub = jax.random.split(c["key"], 4)
            v = jnp.where(jax.random.uniform(k_dir, dtype=dtype) <= 0.5, -1.0, 1.0)
            v = v.astype(dtype)
            backward = v < 0

            if tree_variant == "reference":
                # reference quirk (src/nuts.cpp:242-255): every doubling
                # restarts from the *current draw* with the draw's *initial
                # momentum* instead of extending from the tree endpoint —
                # this breaks Algorithm 6's reversibility and measurably
                # biases asymmetric posteriors (see module docstring);
                # the alpha baseline also tracks the mid-loop-updated draw
                # (src/nuts.cpp:260-270 updates prev_U inside the doubling
                # loop)
                start_z, start_r = c["draw"], r0
                alpha_base = c["U"] + prev_K
            else:
                # Hoffman-Gelman Algorithm 6: extend the trajectory from the
                # endpoint in the chosen direction; accept-stat baseline is
                # the draw's initial Hamiltonian
                start_z = jnp.where(backward, c["neg_z"], c["pos_z"])
                start_r = jnp.where(backward, c["neg_r"], c["pos_r"])
                alpha_base = state.potential + prev_K

            sub = build_subtree(
                k_sub, c["depth"], v, start_z, start_r, eps, log_u, alpha_base,
                dim, dtype, inv_mass,
            )

            n_p = sub["n"]
            s_p = sub["s"]
            zu = jax.random.uniform(k_acc, dtype=dtype)
            do_acc = (s_p == 1) & (zu * c["n"].astype(dtype) < n_p.astype(dtype))

            draw = jnp.where(do_acc, sub["prop_z"], c["draw"])
            U = jnp.where(do_acc, sub["prop_U"], c["U"])

            neg_z = jnp.where(backward, sub["z"], c["neg_z"])
            neg_r = jnp.where(backward, sub["r"], c["neg_r"])
            pos_z = jnp.where(backward, c["pos_z"], sub["z"])
            pos_r = jnp.where(backward, c["pos_r"], sub["r"])

            span = pos_z - neg_z
            check1 = jnp.dot(span, neg_r) >= 0
            check2 = jnp.dot(span, pos_r) >= 0
            s = (s_p * check1.astype(jnp.int32) * check2.astype(jnp.int32))

            return {
                "key": key, "depth": c["depth"] + 1, "n": c["n"] + n_p, "s": s,
                "draw": draw, "U": U,
                "pos_z": pos_z, "neg_z": neg_z, "pos_r": pos_r, "neg_r": neg_r,
                "alpha": sub["alpha"], "n_alpha": sub["n_alpha"],
                "good": c["good"] | do_acc, "div": c["div"] | sub["div"],
            }

        out = lax.while_loop(outer_cond, outer_body, carry)

        # dual averaging (reference src/nuts.cpp:294-302); with pooled
        # adaptation the accept statistic is averaged over the named chain
        # axis (lax.pmean -> psum collective when chains are mesh-sharded),
        # giving all chains one common step-size trajectory. With mass
        # adaptation the averaging clock restarts at each window end
        # (adapt_t0), Stan-style.
        t = (state.draw_ind - state.adapt_t0).astype(dtype)
        adapting = state.draw_ind < n_adapt
        accept_stat = out["alpha"] / jnp.maximum(out["n_alpha"], 1).astype(dtype)
        if pooled_adaptation:
            accept_stat = lax.pmean(accept_stat, common.CHAIN_AXIS_NAME)
        h_new = state.h_val + (1.0 / (t + 1.0 + cfg.t0_val)) \
            * (cfg.target_accept_rate - accept_stat - state.h_val)
        eps_new = jnp.exp(state.mu_val - h_new * jnp.sqrt(t + 1.0) / cfg.gamma_val)
        ebar_new = state.epsilon_bar * jnp.exp(
            (t + 1.0) ** (-cfg.kappa_val)
            * (jnp.log(eps_new) - jnp.log(state.epsilon_bar))
        )

        step_size_out = jnp.where(adapting, eps_new, state.epsilon_bar)
        ebar_out = jnp.where(adapting, ebar_new, state.epsilon_bar)
        h_out = jnp.where(adapting, h_new, state.h_val)
        mu_out = state.mu_val
        t0_out = state.adapt_t0
        inv_mass_out = state.inv_mass
        chol_out = state.mass_chol
        wc, wm, wv = state.w_count, state.w_mean, state.w_m2

        if adapt_mass:
            idx = jnp.minimum(state.draw_ind, mass_collect.shape[0] - 1)
            collecting = adapting & mass_collect[idx]
            window_end = adapting & mass_window_end[idx]

            # windowed Welford -> regularized mass (shared machinery;
            # pooled across chains under pooled_adaptation), then reset the
            # dual-averaging clock below
            wc, wm, wv, inv_mass_out, chol_out = \
                adaptation.windowed_mass_update(
                    wc, wm, wv, inv_mass_out, chol_out, out["draw"],
                    collecting, window_end, mass_mode,
                    axis_name=common.CHAIN_AXIS_NAME if pooled_adaptation
                    else None)
            mu_out = jnp.where(window_end, jnp.log(10.0 * step_size_out), mu_out)
            h_out = jnp.where(window_end, 0.0, h_out)
            t0_out = jnp.where(window_end, state.draw_ind + 1, t0_out)
            ebar_out = jnp.where(window_end, step_size_out, ebar_out)

        depth_hist = state.depth_hist
        depth_cap = state.depth_cap
        if adapt_depth:
            # histogram realized depths over the settled second half of
            # warmup; at the last warmup draw, set the budget to the
            # depth_quantile depth (+1 margin), pooled across chains when
            # pooled_adaptation (all vmap lanes then share one budget).
            # Cost note: the cumsum/argmax (O(max_depth) elementwise) and
            # the (max_depth+1,)-int psum run every draw because vmapped
            # lax.cond lowers to select anyway — negligible next to the
            # 2^depth leapfrogs each draw pays.
            settling = adapting & (state.draw_ind >= n_adapt // 2)
            hist1 = depth_hist.at[jnp.minimum(out["depth"], max_depth)].add(1)
            depth_hist = jnp.where(settling, hist1, depth_hist)
            last_warmup = state.draw_ind == n_adapt - 1
            pooled_hist = lax.psum(depth_hist, common.CHAIN_AXIS_NAME) \
                if pooled_adaptation else depth_hist
            total = jnp.maximum(pooled_hist.sum(), 1)
            cum = jnp.cumsum(pooled_hist)
            q_depth = jnp.argmax(cum >= depth_quantile * total.astype(cum.dtype))
            new_cap = jnp.minimum(q_depth.astype(jnp.int32) + 1, max_depth)
            depth_cap = jnp.where(last_warmup, new_cap, depth_cap)

        new_state = NUTSState(
            position=out["draw"],
            potential=out["U"],
            step_size=step_size_out,
            epsilon_bar=ebar_out,
            h_val=h_out,
            mu_val=mu_out,
            draw_ind=state.draw_ind + 1,
            adapt_t0=t0_out,
            inv_mass=inv_mass_out,
            mass_chol=chol_out,
            w_count=wc,
            w_mean=wm,
            w_m2=wv,
            depth_hist=depth_hist,
            depth_cap=depth_cap,
        )
        info = {
            "accepted": out["good"],
            "tree_depth": out["depth"],
            "diverged": out["div"],
            "accept_stat": accept_stat,
            "step_size": eps,
        }
        return new_state, info

    return init, step


def nuts(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None, mesh=None,
         checkpoint_dir=None, checkpoint_every=500,
         dtype=None, bounded_grad="reference",
         pooled_adaptation=False, adapt_mass_matrix=False,
         adapt_depth=False, depth_quantile=0.98, static_sampling_depth=False,
         tree_variant="endpoint", sample_method="slice", thin=1,
         warmup_tree_depth=None, return_resume=False) -> SamplerResult:
    """Run NUTS (reference src/nuts.cpp entry points).

    ``return_resume=True`` attaches ``diagnostics["resume"](key, n_keep)``
    — a warm continuation from the final kernel state (no re-warmup; the
    adapted step size / mass / depth budget carry over). Incompatible with
    ``checkpoint_dir`` (whose artifact dir encodes a fixed total).

    ``pooled_adaptation=True`` shares one dual-averaging step-size
    trajectory across all chains by pooling the per-draw accept statistic
    over the chain axis — a cross-chain generalization the single-chain
    reference cannot express (SURVEY.md §7 step 8: psum warmup statistics).

    ``warmup_tree_depth=k`` caps the doubling budget during the FIRST
    half of warmup only — the phase where a not-yet-adapted step size
    makes whole vmapped batches pay near-max-depth trees (measured ~36x
    the settled per-draw cost on the flagship). NUTS is a valid kernel
    at any cap, the second (histogram) half and sampling run the full
    budget, so posterior and learned depth budget are unaffected; only
    early-warmup wall-clock drops. Off by default (reference parity).

    ``sample_method="multinomial"`` replaces the slice-sampler tree of the
    reference (Hoffman-Gelman Algorithm 6) with Boltzmann-weighted leaves
    (Betancourt 2017 — what modern Stan runs): better proposals from the
    same trajectories, typically +10-30% ESS. Only with the default
    ``tree_variant="endpoint"``.

    ``adapt_depth=True`` learns a tree-depth budget during warmup: realized
    depths over the second half of warmup are histogrammed and the sampling
    phase caps the doubling loop at the ``depth_quantile`` depth + 1. Under
    ``vmap`` every chain pays the slowest chain's tree each draw, so capping
    the rare deep trees is the main straggler-mitigation lever; NUTS
    remains a valid kernel at any maximum depth (the cap is the same knob as
    ``max_tree_depth``, chosen from data). Combine with
    ``pooled_adaptation`` to share one budget across all chains.

    ``static_sampling_depth=True`` (requires ``adapt_depth``) goes further:
    after warmup the sampling kernel is REBUILT with the learned budget as
    the static ``max_tree_depth``, so the checkpoint buffers shrink from
    ``(max_tree_depth + 1, d)`` to ``(cap + 1, d)`` and the per-leaf
    progressive U-turn scan runs ``cap`` levels instead of
    ``max_tree_depth``. At flagship shapes the draw cost is this
    bookkeeping, not gradients (benchmarks/nuts_probe.py ``ta65-static``
    compares it with the dynamic tree). Costs one host sync + one extra compile between phases;
    incompatible with ``checkpoint_dir`` (the state template's shape
    changes mid-run) and requires ``n_adapt_draws <= n_burnin_draws``.

    ``adapt_mass_matrix=True`` (or ``"diag"``) adds Stan-style windowed
    diagonal mass-matrix adaptation during warmup (doubling slow windows of
    Welford variance estimates; dual averaging restarts at window ends);
    ``"dense"`` estimates the full posterior covariance instead (O(d^2)
    state per chain — right for strongly correlated posteriors of modest
    dimension). The reference has no analog — its preconditioner is a fixed
    user matrix (mcmc_structs.hpp:93). Combine with ``pooled_adaptation``
    to estimate one shared mass from all chains. Incompatible with a user
    ``precond_mat``.
    """
    algo, s = resolve_settings(settings, "nuts_settings", NUTSSettings)
    key = resolve_key(key, algo)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains, dtype)
    precond = common.make_spd(s.precond_mat, prob.n_vals, prob.dtype)
    grad_fn = integrators.make_kick_grad(prob, bounded_grad)

    n_total = s.n_burnin_draws + s.n_keep_draws
    n_adapt = min(s.n_adapt_draws, n_total)  # reference src/nuts.cpp:54

    if adapt_mass_matrix and s.precond_mat is not None:
        raise ValueError("adapt_mass_matrix is incompatible with a user "
                         "precond_mat — the mass matrix is learned")
    if static_sampling_depth:
        if not adapt_depth:
            raise ValueError("static_sampling_depth requires adapt_depth "
                             "(the static size is the learned budget)")
        if checkpoint_dir is not None:
            raise ValueError(
                "static_sampling_depth is incompatible with checkpoint_dir: "
                "the sampler-state template changes shape between warmup "
                "and sampling, which would invalidate the checkpoint")
        if n_adapt > s.n_burnin_draws:
            raise ValueError(
                f"static_sampling_depth requires n_adapt_draws "
                f"({n_adapt}) <= n_burnin_draws ({s.n_burnin_draws}): the "
                f"budget must be learned before the sampling kernel is "
                f"rebuilt")
    if warmup_tree_depth is not None and int(warmup_tree_depth) < 1:
        raise ValueError(f"warmup_tree_depth must be >= 1, got "
                         f"{warmup_tree_depth}")
    init, step = build_nuts_kernel(prob.box_log_kernel, grad_fn, precond, s,
                                   n_adapt, pooled_adaptation,
                                   adapt_mass_matrix, adapt_depth,
                                   depth_quantile, tree_variant,
                                   sample_method,
                                   warmup_tree_depth=warmup_tree_depth)

    key, k_init = jax.random.split(key)
    init_keys = jax.random.split(k_init, prob.n_chains)
    state0 = jax.vmap(init, axis_name=common.CHAIN_AXIS_NAME)(
        init_keys, prob.first_draw)

    n_burnin_run = s.n_burnin_draws
    if static_sampling_depth:
        # phase 1: warmup with the full-size tree, nothing collected
        key, k_warm = jax.random.split(key)
        state0, _, _ = common.run_sampler_loop(
            k_warm, state0, step, s.n_burnin_draws, 0,
            collect_fn=lambda st: st.position, mesh=mesh, thin=thin)
        # phase 2: rebuild with the learned budget as the STATIC tree size
        # (max over chains — lockstep pays the deepest lane anyway)
        cap = int(jnp.max(jnp.asarray(state0.depth_cap)))
        import dataclasses as _dc
        s_run = _dc.replace(s, max_tree_depth=cap)
        _init2, step = build_nuts_kernel(
            prob.box_log_kernel, grad_fn, precond, s_run, n_adapt,
            pooled_adaptation, adapt_mass_matrix, False, depth_quantile,
            tree_variant, sample_method)
        state0 = state0._replace(
            depth_hist=jnp.zeros(state0.depth_hist.shape[:-1] + (cap + 1,),
                                 jnp.int32),
            depth_cap=jnp.minimum(state0.depth_cap, cap))
        n_burnin_run = 0

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
                "tree_depth": infos["tree_depth"],
                "n_divergent": infos["diverged"].sum(axis=0),
                "accept_stat": infos["accept_stat"],
                "step_size": infos["step_size"],
            }
        else:
            # checkpointed run: per-draw traces are not retained — report the
            # accumulated per-chain totals as counts/means instead
            totals = infos["totals"]
            diagnostics = {
                "n_divergent": jnp.asarray(totals["diverged"]),
                "mean_tree_depth": jnp.asarray(totals["tree_depth"])
                / n_keep,
                "mean_accept_stat": jnp.asarray(totals["accept_stat"])
                / n_keep,
            }
        if adapt_mass_matrix:
            diagnostics["inv_mass_diag"] = final_state.inv_mass
        if adapt_depth:
            diagnostics["depth_cap"] = final_state.depth_cap
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            # per-draw traces are (n_keep, n_chains); counts are (n_chains,);
            # inv_mass_diag is (n_chains, dim)
            def _squeeze(k, v):
                if k == "inv_mass_diag":
                    return v[0]
                return v[:, 0] if v.ndim == 2 else v[0]
            diagnostics = {k: _squeeze(k, v) for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, n_burnin_run,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
