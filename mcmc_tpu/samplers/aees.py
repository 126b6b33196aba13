"""Adaptive equi-energy sampler over a temperature ladder.

Accelerator-native re-design of reference src/aees.cpp:30-305 +
include/mcmc/aees.ipp:30-70. K = ``len(temper_vec) + 1`` chains run a
descending temperature ladder with T = 1 appended; per draw the hottest chain
takes a tempered RWMH step (proposal scaled by ``sqrt(T)``, accept on
``min(0.01, delta/T)`` — aees.ipp:46-53), and each colder chain — once its
staggered activation point ``draw_ind > k * (n_initial + n_burnin)`` passes
(src/aees.cpp:176) — takes either a local tempered step (prob
``1 - ee_prob_par``) or an **equi-energy jump**: the next-hotter chain's
kernel history is sorted into ``n_rings`` energy rings, a stored state is
drawn from the ring matching the chain's current energy, and it is accepted
by the two-temperature ratio (src/aees.cpp:187-240).

Design notes (XLA):
- the sampler is a pure ``(key, state) -> (state, info)`` transition kernel
  with the draw counter in the state, so it runs through the standard scan
  driver, composes with ``checkpoint_dir`` chunked execution, and vmaps over
  replicas;
- the ladder loop is unrolled over the static K with ``lax.cond`` so the
  expensive ring sort only executes on actual EE draws;
- the dynamic-length history window is sorted via masked full-length argsort
  (+inf padding), and the ring walk (src/aees.cpp:208-218) becomes a
  ``searchsorted`` over the ascending ring boundaries;
- each chain's current kernel value is carried, saving the reference's
  re-evaluations (aees.ipp:48, src/aees.cpp:243).

**Bounded-memory mode** (``history_capacity=C``): the reference keeps every
draw of every chain resident — ``draw_storage(n_vals, K, n_total)`` grows
with the run length (src/aees.cpp:143-147, the memory-scaling pain point of
SURVEY.md §5). With a capacity, each chain instead maintains a fixed-size
**reservoir sample** of its history window (Vitter's algorithm R: the t-th
window entry replaces a uniformly random slot with probability C/t), so the
stored subset is uniform over the same window the reference sorts, ring
boundaries become quantile estimates of the same energy distribution, and
memory is O(C * K * d) independent of ``n_total``. Deviation (documented):
ring boundaries/jump candidates come from the uniform subsample rather than
the full window — statistically the same rings, not element-identical.

Deviations from the reference, all fixing uninitialized/undefined behavior
(observed at the cited lines, reproduced here with deterministic intended
semantics):
- src/aees.cpp:60-72 reads one element past ``temper_vec`` and sorts an
  uninitialized slot; here the ladder is exactly user temps + T = 1, sorted
  descending;
- src/aees.cpp:143 never writes row 0 (hottest chain) of ``kernel_vals`` yet
  sorts it for chain 1's rings; here it is written every draw;
- src/aees.cpp:222 uses a window-relative sort index as an absolute index
  into ``draw_storage``; here the jump state is the one actually selected by
  the ring (absolute indices fall out of the masked argsort);
- all chains start at the transformed initial value and history buffers are
  initialized with its kernel value instead of uninitialized memory;
- **Deviation** (NaN accept ratio in the EE jump): src/aees.cpp:238 tests
  ``z > exp(comp)`` — a NaN ``comp`` (kernel -inf at both temperatures)
  compares false and so silently ACCEPTS the jump; the local MH step
  (aees.ipp:57, ``z < exp``) rejects in the same situation. Here both moves
  use the accept-convention comparison (NaN rejects), i.e. the EE jump
  follows the reference's own local-move semantics rather than its
  inconsistent jump branch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu.results import SamplerResult
from mcmc_tpu.settings import AEESSettings
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers._resolve import resolve_settings, resolve_key

__all__ = ["aees", "AEESState", "build_aees_kernel"]


class AEESState(NamedTuple):
    X: jax.Array          # (K, d) current states per ladder position
    cur_kv: jax.Array     # (K,) current kernel values (temperature 1)
    kv2: jax.Array        # (2, K) tempered pairs from the previous draw
    hist_kv: jax.Array    # (H, K) energy history/reservoir
    hist_draws: jax.Array  # (H, K, d) state history/reservoir
    draw_ind: jax.Array   # global draw counter (drives activation + windows)


def make_temps(s: AEESSettings, dt):
    """Temperature ladder: user temps (validated all > 1) + T = 1 appended,
    sorted descending — the intended semantics of src/aees.cpp:60-72 (the
    reference's copy loop has the one-past-end UB documented above). Shared
    by :func:`aees` and :func:`mcmc_tpu.parallel.aees_sharded`."""
    user_temps = jnp.asarray(s.temper_vec, dt) if s.temper_vec is not None \
        else jnp.zeros((0,), dt)
    if user_temps.size and not bool(jnp.all(user_temps > 1.0)):
        raise ValueError(
            "temper_vec entries must all be > 1 (temperatures, not inverse "
            "temperatures); T=1 is appended automatically and the T=1 chain "
            "is the one whose draws are returned")
    return jnp.sort(jnp.concatenate([user_temps, jnp.ones((1,), dt)]))[::-1]


def safe_initial_kv(val, dt):
    """A NaN initial kernel value would NaN every accept comparison and
    wedge the chain; force -inf so the first finite proposal accepts
    (same guard as pt.py; reference inherits whatever the user passes)."""
    return jnp.where(jnp.isfinite(val), val, -jnp.asarray(jnp.inf, dt))


def make_mh_step(box, s: AEESSettings, dim, dt):
    """Tempered single-step MH (reference aees.ipp:30-70); no finiteness
    guard, as in the reference — NaN ratios reject. The ONE implementation
    shared by the library sampler, the ladder-sharded variant
    (:mod:`mcmc_tpu.parallel.aees_sharded`), and — via the runtime-scale
    core — the auto-ladder pilot (:func:`build_ee_ladder`)."""
    core = make_mh_step_scaled(box, s, dim, dt)

    def mh_step(key, x, val_prev, temper):
        x_new, val_new, _acc = core(key, x, val_prev, temper,
                                    jnp.asarray(s.par_scale, dt))
        return x_new, val_new

    return mh_step


def make_mh_step_scaled(box, s: AEESSettings, dim, dt):
    """The tempered-MH core with a RUNTIME proposal scale and the accept
    flag exposed — the single implementation behind :func:`make_mh_step`
    and the self-tuning ladder pilot."""
    cov = common.make_spd(s.cov_mat, dim, dt)

    def mh_step(key, x, val_prev, temper, scale):
        k_n, k_u = jax.random.split(key)
        noise = jax.random.normal(k_n, (dim,), dt)
        prop = x + jnp.sqrt(temper) * (scale * cov.sqrt_mv(noise))
        val_new = box(prop)
        comp = jnp.minimum(0.01, (val_new - val_prev) / temper)
        acc = jax.random.uniform(k_u, dtype=dt) < jnp.exp(comp)
        return (jnp.where(acc, prop, x),
                jnp.where(acc, val_new, val_prev), acc)

    return mh_step


def make_ee_jump(box, n_rings, dt):
    """Core equi-energy jump (reference src/aees.cpp:196-240): sort the
    donor chain's masked energy window into ``n_rings`` rings, draw a
    stored candidate from the ring matching the current energy, accept by
    the two-temperature ratio with ``min(0.01, ·)`` clamp. Shared by the
    library sampler and the ladder-sharded variant so acceptance semantics
    cannot diverge.

    ``row_kv (H,)`` / ``row_x (H, d)`` are the donor history; ``mask`` the
    valid-window mask; ``spacing`` (>0) the per-ring slot count."""
    def jump(key, row_kv, row_x, mask, spacing, cur_x, cur_kv, kv2,
             hotter_temp, my_temp):
        k_pick, k_acc = jax.random.split(key)
        masked = jnp.where(mask, row_kv, jnp.inf)
        order = jnp.argsort(masked)        # slot indices, ascending energy
        sorted_vals = masked[order]

        ring_pos = jnp.arange(1, n_rings) * spacing      # (n_rings - 1,)
        ring_vals = 0.5 * (sorted_vals[ring_pos] + sorted_vals[ring_pos - 1])
        which = jnp.searchsorted(ring_vals, cur_kv)      # rings strictly below

        z = jax.random.uniform(k_pick, dtype=dt)
        idx_rel = spacing * which + jnp.floor(z * spacing).astype(jnp.int32)
        ind_abs = order[idx_rel]

        x_cand = row_x[ind_abs]
        val = box(x_cand)
        new_pair = jnp.array([val / hotter_temp, val / my_temp])
        comp = jnp.minimum(0.01, (new_pair[1] - kv2[1]) + (kv2[0] - new_pair[0]))
        # Deviation (see module docstring): accept-convention comparison so
        # a NaN comp (kernel -inf at both ends) REJECTS, matching mh_step /
        # aees.ipp:57; the reference's jump branch (src/aees.cpp:238 tests
        # z > exp(comp)) would silently accept on NaN.
        acc = jax.random.uniform(k_acc, dtype=dt) < jnp.exp(comp)
        return (jnp.where(acc, x_cand, cur_x),
                jnp.where(acc, val, cur_kv),
                jnp.where(acc, new_pair, kv2),
                acc)

    return jump


def build_ee_ladder(key, box, first, s: AEESSettings, dim, dt, t_max, *,
                    spacing=3.0, max_rungs=16, n_grid=12,
                    n_pilot_chains=8, n_pilot_draws=400, min_rung_temp=1.4):
    """Ladder construction adapted to the EQUI-ENERGY functional.

    The EE jump between adjacent rungs accepts with log-ratio
    ``(val_new - val_cur) * (beta_k - beta_{k-1})`` (src/aees.cpp:222-240
    two-temperature ratio; ``beta = 1/T``), where ``val_new`` comes from
    the donor ring containing the receiver's current energy. Jump
    efficiency is therefore governed by the OVERLAP of the adjacent
    rungs' energy (log-kernel) distributions: the mean energy shift
    between rungs is ``Var_beta(val) * dbeta`` (the standard
    thermodynamic identity ``d<val>/dbeta = Var(val)``), so requiring a
    fixed overlap gives the spacing rule

        ``dbeta = spacing / sigma_val(beta)``

    — adjacent rungs' energy histograms separated by ``spacing`` standard
    deviations. The PT swap-acceptance target (Robbins-Monro 0.234)
    optimizes a DIFFERENT functional (benchmarks/aees_ladder_sweep.py
    compares the two); this rule targets ring overlap directly.

    A short pilot measures ``sigma_val(beta)`` on a geometric beta grid
    (independent tempered RWMH chains, no EE moves), then the ladder is
    walked down from ``beta = 1/t_max`` with the rule above until
    ``beta = 1`` (capped at ``max_rungs``; rungs closer to the target
    than ``min_rung_temp`` are dropped — a T~1.3 rung duplicates the
    appended T=1 chain and was measured to destabilize runs). For a
    d-dimensional Gaussian ``sigma_val = sqrt(d/2)/beta``, so the rule
    reproduces a GEOMETRIC ladder with ratio ``1 + spacing/sqrt(d/2)``
    — the family the sweep found optimal — with the density now set by
    the measured energy scale instead of by hand.

    Default ``spacing=3.0`` is empirical, from a 3-seed study on the
    suite's hard bimodal mixture: it lands within measurement noise of
    the sweep-optimal hand-picked geom4 ladder (constructed [60, 15.5,
    3.6] vs geom4's [60, 15.3, 3.9]; min bulk ESS 1246 vs 1460 with
    seed spread ~±150), while spacing 1.0 (7 rungs) and 2.0 (5 rungs)
    cost ~40% wall-clock for no ESS gain — EE acceptance is already
    ~0.94 at geom4 spacing, so denser rungs only add compute and
    staggered-activation burn-in.

    The pilot's per-temperature proposal scale SELF-TUNES: starting from
    the sampler's own ``par_scale``, the first (burn) half multiplicatively
    adapts each grid temperature's scale toward ~0.3 acceptance
    (``s *= exp(eta * (acc - 0.3))``), and ``sigma_val`` is measured on the
    second half with the scales frozen. Without this, the fixed
    ``par_scale * sqrt(T)`` proposal sticks completely in high dimension,
    ``sigma_val`` reads ~0, and the walk silently jumps straight to T = 1.
    (Tuning only affects pilot MIXING, not the estimand — any correctly
    sampling chain measures the same energy spread.) The tuned scales are
    pilot-internal; the AEES run itself keeps the user's ``par_scale``.

    Returns the user-temp vector (descending, T > 1 only; T = 1 is
    appended by :func:`make_temps`).
    """
    import numpy as np

    beta_grid = jnp.asarray(
        np.geomspace(1.0 / t_max, 1.0, int(n_grid)), dt)
    grid_temps = 1.0 / beta_grid                      # (n_grid,)
    n_burn_half = int(n_pilot_draws) // 2

    pilot_step = make_mh_step_scaled(box, s, dim, dt)

    val0 = safe_initial_kv(box(first), dt)
    x0 = jnp.tile(first[None, None, :],
                  (int(n_grid), int(n_pilot_chains), 1))
    v0 = jnp.full((int(n_grid), int(n_pilot_chains)), val0, dt)
    scale0 = jnp.full((int(n_grid),), float(s.par_scale), dt)

    batched = jax.vmap(jax.vmap(pilot_step, in_axes=(0, 0, 0, None, None)),
                       in_axes=(0, 0, 0, 0, 0))

    @jax.jit
    def pilot(key):
        def body(carry, kt):
            x, v, scale = carry
            k, t = kt
            ks = jax.random.split(k, int(n_grid) * int(n_pilot_chains))
            # reshape preserving the key's own trailing shape: legacy
            # uint32 keys are (N, 2), typed keys are (N,)
            ks = ks.reshape((int(n_grid), int(n_pilot_chains))
                            + ks.shape[1:])
            x, v, acc = batched(ks, x, v, grid_temps, scale)
            # burn half only: multiplicative scale adaptation toward 0.3
            adapting = t < n_burn_half
            new_scale = scale * jnp.exp(
                0.25 * (acc.mean(axis=1).astype(dt) - 0.3))
            scale = jnp.where(adapting, new_scale, scale)
            return (x, v, scale), v
        keys = jax.random.split(key, int(n_pilot_draws))
        ts = jnp.arange(int(n_pilot_draws))
        _, vals = lax.scan(body, (x0, v0, scale0), (keys, ts))
        kept = vals[n_burn_half:]                     # second half only
        moved = (kept[1:] != kept[:-1]).mean(axis=(0, 2))
        return jnp.std(kept, axis=(0, 2)), moved      # (n_grid,) each

    sig, moved = (np.asarray(a, np.float64) for a in pilot(key))
    if moved.min() < 0.02:
        import warnings
        bad = grid_temps[int(np.argmin(moved))]
        warnings.warn(
            f"build_ee_ladder pilot chains barely move at T="
            f"{float(bad):.3g} (acceptance ~{moved.min():.1%}) even after "
            f"proposal-scale self-tuning: sigma_val is underestimated "
            f"there and the constructed ladder may be too sparse. The "
            f"target may be discontinuous/degenerate at that temperature, "
            f"or cov_mat badly mis-shaped for it.",
            stacklevel=3)
    # degenerate pilots (all-rejecting targets leave vals at -inf, whose
    # std is nan) must not poison the walk with nan betas
    sig = np.where(np.isfinite(sig), sig, 0.0)
    sig = np.maximum(sig, 1e-12)
    log_bg = np.log(np.asarray(beta_grid, np.float64))
    log_sig = np.log(sig)

    betas = [1.0 / float(t_max)]
    reached = False
    while len(betas) < int(max_rungs):
        b = betas[-1]
        sig_b = float(np.exp(np.interp(np.log(b), log_bg, log_sig)))
        b_next = b + float(spacing) / sig_b
        if b_next >= 1.0 / float(min_rung_temp):
            reached = True
            break
        betas.append(b_next)
    if not reached:
        import warnings
        warnings.warn(
            f"build_ee_ladder hit max_rungs={max_rungs} at T="
            f"{1.0 / betas[-1]:.3g} before bridging to the T=1 target: "
            f"the coldest constructed rung and the appended T=1 chain "
            f"have an energy-histogram gap wider than `spacing` sigmas, "
            f"so EE jumps into the returned chain will rarely accept. "
            f"Raise max_rungs, raise spacing, or lower the hottest "
            f"temperature.", stacklevel=3)
    return jnp.asarray(1.0 / np.asarray(betas), dt)   # descending temps > 1


def build_aees_kernel(box, temps, s: AEESSettings, dim, dt,
                      history_capacity=None):
    """Returns ``(make_state0, step)`` for the AEES transition kernel.

    ``history_capacity=None`` keeps the reference's full ``(n_total, K)``
    history; an int C keeps a per-chain reservoir of C entries instead (see
    module docstring)."""
    K = int(temps.shape[0])
    block = s.n_initial_draws + s.n_burnin_draws
    n_total = s.n_keep_draws + K * block
    n_rings = int(s.n_rings)
    capped = history_capacity is not None
    H = int(history_capacity) if capped else n_total

    mh_step = make_mh_step(box, s, dim, dt)
    ee_jump = make_ee_jump(box, n_rings, dt)
    idx_slots = jnp.arange(H)

    def store(hist_kv, hist_draws, j, kv, x, draw_ind, k_res):
        """Record chain j's draw into its history slot (full mode) or
        reservoir (capped mode). The donor window for reader j+1 starts at
        j*block (reference begin = (k-1)*block, src/aees.cpp:196)."""
        if not capped:
            return (hist_kv.at[draw_ind, j].set(kv),
                    hist_draws.at[draw_ind, j].set(x))
        t = draw_ind - j * block + 1          # window entries seen so far
        in_window = t >= 1
        k_u, k_slot = jax.random.split(k_res)
        u = jax.random.uniform(k_u, dtype=dt)
        rand_slot = jax.random.randint(k_slot, (), 0, H)
        accept_repl = u * t.astype(dt) < float(H)   # prob C/t
        slot = jnp.where(t <= H, jnp.maximum(t - 1, 0), rand_slot)
        do = in_window & ((t <= H) | accept_repl)
        hist_kv = jnp.where(do, hist_kv.at[slot, j].set(kv), hist_kv)
        hist_draws = jnp.where(do, hist_draws.at[slot, j].set(x), hist_draws)
        return hist_kv, hist_draws

    def ee_move(key, k, draw_ind, state: AEESState, hist_kv, hist_draws):
        """Equi-energy jump for ladder position k (src/aees.cpp:187-240).

        ``hist_kv``/``hist_draws`` already contain the *current* draw's
        entries for hotter chains, matching the reference's sequential
        (OpenMP-free) execution order where chain k-1 writes
        ``kernel_vals(k-1, draw_ind)`` before chain k sorts the window
        [begin, draw_ind] (src/aees.cpp:196-199, 243)."""
        begin = (k - 1) * block
        length = draw_ind - begin + 1
        avail = jnp.minimum(length, H) if capped else length
        spacing = avail // n_rings

        def jump(_):
            if capped:
                mask = idx_slots < avail
            else:
                mask = (idx_slots >= begin) & (idx_slots <= draw_ind)
            x, kv, pair, acc = ee_jump(
                key, hist_kv[:, k - 1], hist_draws[:, k - 1],
                mask, spacing, state.X[k], state.cur_kv[k],
                state.kv2[:, k], temps[k - 1], temps[k])
            return x, kv, pair, jnp.asarray(True), acc

        def stay(_):
            return (state.X[k], state.cur_kv[k], state.kv2[:, k],
                    jnp.asarray(False), jnp.asarray(False))

        return lax.cond(spacing > 0, jump, stay, None)

    def chain_update(key, k, draw_ind, state: AEESState, hist_kv, hist_draws):
        """Per-draw update for ladder position k >= 1 (src/aees.cpp:166-247).

        State reads (X, kernel pairs) come from the previous draw's snapshot
        ``state`` (reference copies X_prev/kernel_vals_prev before the ladder
        loop, src/aees.cpp:153-154); only the ring history sees the current
        draw's hotter-chain entries."""
        k_sel, k_move = jax.random.split(key)

        def local_branch(_):
            x_new, val = mh_step(k_move, state.X[k], state.cur_kv[k], temps[k])
            pair = jnp.array([val / temps[k - 1], val / temps[k]])
            return (x_new, val, pair,
                    jnp.asarray(False), jnp.asarray(False))

        def ee_branch(_):
            return ee_move(k_move, k, draw_ind, state, hist_kv, hist_draws)

        def active_branch(_):
            z_eps = jax.random.uniform(k_sel, dtype=dt)
            return lax.cond(z_eps > s.ee_prob_par, local_branch, ee_branch, None)

        def inactive_branch(_):
            return (state.X[k], state.cur_kv[k], state.kv2[:, k],
                    jnp.asarray(False), jnp.asarray(False))

        active = draw_ind > k * block
        return lax.cond(active, active_branch, inactive_branch, None)

    def step(key, state: AEESState):
        draw_ind = state.draw_ind
        keys = jax.random.split(key, 2 * K)

        # hottest chain (src/aees.cpp:160-164)
        x0, val0 = mh_step(keys[0], state.X[0], state.cur_kv[0], temps[0])
        X_new = state.X.at[0].set(x0)
        cur_kv = state.cur_kv.at[0].set(val0)
        kv2 = state.kv2.at[:, 0].set(val0)
        hist_kv, hist_draws = store(state.hist_kv, state.hist_draws, 0,
                                    val0, x0, draw_ind, keys[K])

        # ladder loop, statically unrolled; each chain's history entry is
        # written before the next (colder) chain reads the ring window
        ee_att = [jnp.asarray(False)]
        ee_acc = [jnp.asarray(False)]
        for k in range(1, K):
            xk, kvk, pairk, att, acc = chain_update(keys[k], k, draw_ind,
                                                    state, hist_kv,
                                                    hist_draws)
            X_new = X_new.at[k].set(xk)
            cur_kv = cur_kv.at[k].set(kvk)
            kv2 = kv2.at[:, k].set(pairk)
            hist_kv, hist_draws = store(hist_kv, hist_draws, k, kvk, xk,
                                        draw_ind, keys[K + k])
            ee_att.append(att)
            ee_acc.append(acc)

        new_state = AEESState(X=X_new, cur_kv=cur_kv, kv2=kv2,
                              hist_kv=hist_kv, hist_draws=hist_draws,
                              draw_ind=draw_ind + 1)
        # per-rung EE-jump attempt/accept flags (rung 0 never jumps) — the
        # measured equi-energy functional that ladder adaptation targets
        return new_state, {"ee_attempt": jnp.stack(ee_att),
                           "ee_accept": jnp.stack(ee_acc)}

    def make_state0(first, val_init):
        return AEESState(
            X=jnp.tile(first[None, :], (K, 1)),
            cur_kv=jnp.full((K,), val_init, dt),
            kv2=jnp.stack([val_init / jnp.roll(temps, 1), val_init / temps]),
            hist_kv=jnp.full((H, K), val_init, dt),
            hist_draws=jnp.tile(first[None, None, :], (H, K, 1)),
            draw_ind=jnp.asarray(0, jnp.int32),
        )

    return make_state0, step


def aees(initial_vals, log_kernel, settings=None, *, key=None, n_runs=None,
         mesh=None, checkpoint_dir=None, checkpoint_every=500,
         history_capacity=None, adapt_ladder=False, n_ladder_adapt=None,
         ladder_spacing=3.0, max_rungs=16, dtype=None) -> SamplerResult:
    """Run AEES. Returns the final ``n_keep_draws`` draws of the T = 1 chain
    (reference src/aees.cpp:255-270).

    ``n_runs`` vmaps that many independent ladder replicas (draws come back
    as ``(n_keep, n_runs, n_vals)``), and ``mesh`` shards the replica axis
    over the device mesh (each device runs whole ladders — embarrassingly
    parallel, no collectives). Note the EE branch's history sort then
    executes every draw for every replica (vmap turns ``lax.cond`` into
    ``select``), trading compute for batching — the intended use is many
    replicas on an accelerator where the sort batches well; ``history_capacity``
    bounds that sort to O(C log C) as well as making memory independent of
    the run length (see module docstring).

    ``adapt_ladder=True`` (or ``"ee"``) tunes the temperature ladder to
    the EQUI-ENERGY functional before sampling: a short pilot measures
    the log-kernel standard deviation across inverse temperatures, then
    rungs are placed at ``dbeta = ladder_spacing / sigma_val(beta)`` —
    the spacing that fixes the adjacent-rung energy-histogram overlap
    the EE jump acceptance is driven by (:func:`build_ee_ladder`;
    benchmarks/aees_ladder_sweep.py compares it with the PT swap
    target). Only ``max(
    temper_vec)`` is used (the hottest rung); the rung COUNT emerges
    from the walk (capped at ``max_rungs``). ``adapt_ladder="pt"``
    keeps the legacy Robbins-Monro PT pre-run toward the 0.234 swap
    target (measured to transfer poorly — kept for comparison);
    ``n_ladder_adapt`` sets that pre-run's length. The reference leaves
    ladder choice entirely to the user (src/aees.cpp:60-72 just sorts
    what it is given). The adapted ladder is reported in
    ``diagnostics["temperatures"]``; per-rung EE-jump acceptance over
    kept draws in ``diagnostics["ee_accept_rate"]``."""
    algo, s = resolve_settings(settings, "aees_settings", AEESSettings)
    key = resolve_key(key, algo)

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype)
    dim = prob.n_vals
    dt = prob.dtype
    box = prob.box_log_kernel

    if adapt_ladder:
        if s.temper_vec is None:
            raise ValueError("adapt_ladder requires an initial temper_vec "
                             "(its max sets the hottest rung)")
        mode = "ee" if adapt_ladder is True else adapt_ladder
        import dataclasses
        if mode == "ee":
            import numpy as np
            key, k_ladder = jax.random.split(key)
            t_max = float(np.asarray(s.temper_vec).max())
            adapted = build_ee_ladder(
                k_ladder, box, prob.first_draw[0], s, dim, dt, t_max,
                spacing=ladder_spacing, max_rungs=max_rungs)
            s = dataclasses.replace(s, temper_vec=adapted)
        elif mode == "pt":
            from mcmc_tpu.samplers.pt import pt as _pt
            from mcmc_tpu.settings import AlgoSettings, PTSettings
            key, k_ladder = jax.random.split(key)
            n_pre = int(n_ladder_adapt) if n_ladder_adapt is not None \
                else int(s.n_initial_draws) + int(s.n_burnin_draws)
            pt_algo = AlgoSettings(
                vals_bound=algo.vals_bound, lower_bounds=algo.lower_bounds,
                upper_bounds=algo.upper_bounds,
                pt_settings=PTSettings(
                    n_burnin_draws=n_pre, n_keep_draws=1,
                    temper_vec=s.temper_vec, inner="rwmh",
                    par_scale=s.par_scale, cov_mat=s.cov_mat,
                    adapt_temps=True))
            pre = _pt(initial_vals, log_kernel, pt_algo, n_chains=32,
                      key=k_ladder)
            adapted = pre.diagnostics["temperatures"]  # descending, T=1 last
            s = dataclasses.replace(s, temper_vec=adapted[:-1])
        else:
            raise ValueError(
                f"adapt_ladder must be False, True, 'ee', or 'pt', got "
                f"{adapt_ladder!r}")

    temps = make_temps(s, dt)
    K = int(temps.shape[0])
    block = s.n_initial_draws + s.n_burnin_draws

    make_state0, step = build_aees_kernel(box, temps, s, dim, dt,
                                          history_capacity)

    first = prob.first_draw[0]
    val_init = safe_initial_kv(box(first), dt)
    state0 = make_state0(first, val_init)

    n_burn = K * block
    n_keep = s.n_keep_draws

    if checkpoint_dir is not None:
        from mcmc_tpu.checkpoint import ChunkedRunner
        if n_runs is None:
            runner = ChunkedRunner(step, collect_fn=lambda st: st.X[K - 1],
                                   directory=checkpoint_dir, single_key=True)
            st0 = state0
        else:
            runner = ChunkedRunner(jax.vmap(step),
                                   collect_fn=lambda st: st.X[:, K - 1],
                                   directory=checkpoint_dir, mesh=mesh)
            st0 = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x, (n_runs,) + x.shape), state0)
        _, draws, totals = runner.run(key, st0, n_draws=n_keep,
                                      n_burnin=n_burn,
                                      chunk_size=checkpoint_every)
        draws = jnp.asarray(draws)
        att = totals.get("ee_attempt")
        acc = totals.get("ee_accept")
    elif n_runs is None:
        def body(carry, _):
            st, k = carry
            k, sub = jax.random.split(k)
            st, info = step(sub, st)
            return (st, k), (st.X[K - 1], info)

        def body_burn(carry, _):
            carry, _out = body(carry, None)
            return carry, None

        carry = (state0, key)
        carry, _ = lax.scan(body_burn, carry, None, length=n_burn)
        _, (draws, infos) = lax.scan(body, carry, None, length=n_keep)
        att = infos["ee_attempt"].sum(axis=0)   # (K,)
        acc = infos["ee_accept"].sum(axis=0)
    else:
        # replicas ride the standard chain-batched scan driver — which also
        # shards the replica axis over a mesh (whole ladders per device,
        # collective-free)
        st0 = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (n_runs,) + x.shape), state0)
        # collect_fn sees the replica-batched state: (n_runs, K, d)
        _, draws, infos = common.run_sampler_loop(
            key, st0, step, n_burn, n_keep,
            collect_fn=lambda st: st.X[:, K - 1], mesh=mesh)
        # (n_keep, n_runs, K) -> pooled over draws and replicas
        att = infos["ee_attempt"].sum(axis=(0, 1))
        acc = infos["ee_accept"].sum(axis=(0, 1))

    draws = common.finalize_draws(draws, prob)
    diagnostics = {"temperatures": temps}
    if att is not None:
        att = jnp.asarray(att).reshape(-1, K).sum(axis=0)
        acc = jnp.asarray(acc).reshape(-1, K).sum(axis=0)
        # rung 0 never jumps; rate over KEPT draws (reference counting
        # convention, src/rwmh.cpp:140-142)
        diagnostics["ee_attempts"] = att
        diagnostics["ee_accept_rate"] = acc / jnp.maximum(att, 1)
    # the reference's AEES tracks no acceptance at all (aees_settings_t has
    # no n_accept_draws field); report the cold chain's kept-draw move count
    # — the draw changed iff a local or EE move was accepted
    moved = jnp.any(draws[1:] != draws[:-1], axis=-1).sum(axis=0)
    return SamplerResult(
        draws=draws,
        n_accept_draws=moved,
        diagnostics=diagnostics,
    )
