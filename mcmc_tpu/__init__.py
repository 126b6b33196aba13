"""mcmc_tpu — an accelerator-native MCMC inference engine.

A from-scratch JAX/XLA/Pallas re-design of the capability set of MCMCLib
(kthohr/mcmc, reference at /root/reference): seven MCMC samplers driven by a
user-supplied log-posterior kernel, re-architected Accelerator-first:

- the user target is a pure JAX function ``log_kernel(params) -> scalar``
  (autodiff via :func:`jax.grad` replaces the reference's ``grad_out*``
  callback convention and its external ``autodiff`` C++ library —
  see reference README.md:290-402);
- every sampler is a pure ``(key, state) -> (state, info)`` transition kernel,
  scanned over draws with :func:`jax.lax.scan` and vmapped over thousands of
  chains per chip;
- population/ladder samplers (DE-MCMC, AEES) treat chains as a sharded batch
  axis over a :class:`jax.sharding.Mesh`, with XLA collectives replacing the
  reference's OpenMP thread loops (reference src/de.cpp:161, src/aees.cpp:167).

Public API mirrors the reference's seven entry points
(reference include/mcmc/mcmc_algos.hpp):

    rwmh, mala, hmc, nuts, rmhmc, de, aees

plus the settings types of reference include/misc/mcmc_structs.hpp.
"""

from mcmc_tpu.settings import (
    AlgoSettings,
    RWMHSettings,
    MALASettings,
    HMCSettings,
    GHMCSettings,
    NUTSSettings,
    ChEESSettings,
    RMHMCSettings,
    DESettings,
    DEMCZSettings,
    AEESSettings,
    PTSettings,
    SMCSettings,
    StretchSettings,
    SGLDSettings,
    SGHMCSettings,
    EllipticalSettings,
    SliceSettings,
    GibbsSettings,
    MCLMCSettings,
    MAMSSettings,
    EvidenceSettings,
    BarkerSettings,
    MMALASettings,
)
from mcmc_tpu.results import SamplerResult
from mcmc_tpu.samplers.rwmh import rwmh
from mcmc_tpu.samplers.mala import mala
from mcmc_tpu.samplers.hmc import hmc
from mcmc_tpu.samplers.ghmc import ghmc
from mcmc_tpu.samplers.nuts import nuts
from mcmc_tpu.samplers.chees import chees
from mcmc_tpu.samplers.rmhmc import rmhmc
from mcmc_tpu.samplers.de import de
from mcmc_tpu.samplers.demcz import demcz
from mcmc_tpu.samplers.aees import aees
from mcmc_tpu.samplers.pt import pt
from mcmc_tpu.samplers.smc import smc
from mcmc_tpu.samplers.stretch import stretch
from mcmc_tpu.samplers.sgld import sgld, sghmc
from mcmc_tpu.samplers.ellipse import elliptical_slice
from mcmc_tpu.samplers.slice import slice_sampler
from mcmc_tpu.samplers.gibbs import gibbs
from mcmc_tpu.samplers.mclmc import mclmc, mams
from mcmc_tpu.samplers.barker import barker
from mcmc_tpu.samplers.mmala import mmala
from mcmc_tpu.laplace import map_laplace, LaplaceResult
from mcmc_tpu.evidence import thermo_evidence, EvidenceResult
from mcmc_tpu.pathfinder import pathfinder, PathfinderResult
from mcmc_tpu.nested import nested_sampling, NestedResult
from mcmc_tpu.advi import advi, ADVIResult
from mcmc_tpu.svgd import svgd, SVGDResult
from mcmc_tpu.model_compare import (
    pointwise_log_lik,
    waic,
    psis_loo,
    compare,
)
from mcmc_tpu.pytree import ravel_model, unravel_draws, bounds_like
from mcmc_tpu.metrics import softabs_metric
from mcmc_tpu.predictive import generated_quantities, posterior_predictive
from mcmc_tpu.sbc import sbc
from mcmc_tpu import bounds
from mcmc_tpu import stats
from mcmc_tpu import diagnostics
from mcmc_tpu import models

import jax
import jax.numpy as jnp

__version__ = "0.1.0"

_SAMPLERS = {
    "rwmh": rwmh, "mala": mala, "hmc": hmc, "ghmc": ghmc, "nuts": nuts,
    "chees": chees,
    "rmhmc": rmhmc, "de": de, "demcz": demcz, "aees": aees, "pt": pt,
    "smc": smc,
    "stretch": stretch, "sgld": sgld, "sghmc": sghmc,
    "elliptical": elliptical_slice,
    "slice": slice_sampler,
    "gibbs": gibbs,
    "mclmc": mclmc, "mams": mams,
    "barker": barker, "mmala": mmala,
}


def sample(algorithm, initial_vals, log_kernel, settings=None, **kwargs):
    """One-call dispatcher over the samplers (the reference seven plus
    the accelerator-native extensions).

    ``sample("nuts", x0, log_kernel, settings, n_chains=..., ...)`` is
    equivalent to calling the named entry point directly. RM-HMC requires
    a ``metric_fn=`` keyword; SGLD interprets ``log_kernel`` as the
    log-PRIOR and requires ``log_lik=`` and ``data=`` keywords (the
    minibatched likelihood lives outside the single-callback convention);
    ``"elliptical"`` interprets ``log_kernel`` as the log-LIKELIHOOD only
    (the Gaussian prior is passed via ``prior_mean=``/``prior_cov=``).
    """
    try:
        fn = _SAMPLERS[algorithm]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; choose from {sorted(_SAMPLERS)}"
        ) from None
    if algorithm in ("rmhmc", "mmala"):
        metric_fn = kwargs.pop("metric_fn", None)
        if metric_fn is None:
            raise ValueError(f"{algorithm} requires metric_fn=")
        return fn(initial_vals, log_kernel, metric_fn, settings, **kwargs)
    if algorithm == "gibbs" and "blocks" not in kwargs:
        raise ValueError("gibbs requires blocks= (the block partition is "
                         "model structure: [(indices, method[, opts]), ...])")
    if algorithm in ("sgld", "sghmc"):
        log_lik = kwargs.pop("log_lik", None)
        data = kwargs.pop("data", None)
        if log_lik is None or data is None:
            raise ValueError(f"{algorithm} requires log_lik= and data= "
                             f"(log_kernel is the log-prior)")
        return fn(initial_vals, log_kernel, log_lik, data, settings, **kwargs)
    return fn(initial_vals, log_kernel, settings, **kwargs)


def _fit_ravel(initial_vals, log_kernel, lower_bounds, upper_bounds):
    """Pytree front-end for :func:`fit`: structured initial values (a dict,
    or anything :func:`jnp.asarray` rejects) auto-ravel through
    :func:`ravel_model`; bounds given as pytree prefixes (or scalars) map
    through :func:`bounds_like`. Returns
    ``(x0, log_kernel, lb, ub, unravel)`` with ``unravel=None`` for plain
    flat input."""
    if callable(initial_vals) and not hasattr(initial_vals, "__array__"):
        # the classic (log_kernel, initial_vals) swap — fall through to the
        # flat path so setup_problem raises its actionable "argument order"
        # TypeError instead of a deep ravel_pytree dtype error
        return initial_vals, log_kernel, lower_bounds, upper_bounds, None
    is_tree = isinstance(initial_vals, dict)
    if not is_tree:
        try:
            jnp.asarray(initial_vals)
        except (TypeError, ValueError):
            is_tree = True
    if not is_tree:
        return initial_vals, log_kernel, lower_bounds, upper_bounds, None
    x0, lk, unravel = ravel_model(initial_vals, log_kernel)
    if lower_bounds is not None:
        lower_bounds = bounds_like(initial_vals, lower_bounds, -jnp.inf)
    if upper_bounds is not None:
        upper_bounds = bounds_like(initial_vals, upper_bounds, jnp.inf)
    return x0, lk, lower_bounds, upper_bounds, unravel


def fit(initial_vals, log_kernel, *, n_chains=8, n_warmup=1000, n_draws=1000,
        key=None, mesh=None, algorithm="nuts", dense_mass=False,
        target_accept=None, max_tree_depth=10, n_leap_steps=16, init=None,
        lower_bounds=None, upper_bounds=None,
        rhat_target=None, min_ess=None, max_rounds=8,
        checkpoint_dir=None, thin=1, blocks=None, warmup_tree_depth=6):
    """One-call posterior fit with full automatic warmup.

    ``algorithm="nuts"`` (default) runs NUTS with pooled dual-averaging
    step-size adaptation and windowed mass-matrix adaptation (diagonal, or
    full-covariance with ``dense_mass=True``); ``algorithm="chees"`` runs
    ChEES-HMC with diagonal mass — built for large lockstep chain batches
    (no tree, so no chain waits on another's).
    ``target_accept`` defaults per algorithm (0.8 NUTS / 0.651 ChEES /
    0.8 HMC / 0.574 MALA); ``dense_mass`` selects full-covariance mass
    (NUTS/ChEES/HMC) or a dense learned preconditioner (MALA, unbounded
    only); ``max_tree_depth`` and ``warmup_tree_depth`` are NUTS-only
    (the latter caps the doubling budget during warmup's first half —
    ~1.7x faster time-to-posterior at unchanged quality; ``None``
    disables for reference-parity warmup). ``algorithm="hmc"`` runs
    fixed-trajectory HMC (``n_leap_steps`` leapfrogs, default 16) with
    adapted step size and mass — the predictable-cost gradient sampler;
    ``algorithm="mala"`` runs MALA with adapted step size and learned
    preconditioner — the one-gradient-per-draw choice for cheap targets;
    ``algorithm="ghmc"`` runs generalized HMC (Horowitz persistent
    momentum) — one gradient per draw with HMC-like coherent motion,
    adapted to 0.95 acceptance;
    ``algorithm="barker"`` runs the Barker proposal with adapted scale and
    per-coordinate preconditioning — MALA's robust sibling (insensitive to
    step-size mis-tuning, ergodic on light-tailed targets where MALA is
    transient), the safe gradient default on unfamiliar geometry.
    ``algorithm="stretch"`` runs the affine-invariant ensemble — the
    derivative-free choice when ``log_kernel`` is not differentiable
    (``n_chains`` maps to walkers, min ``max(2 * dim, 32)`` and even; no
    tuning parameters exist to warm up, so ``n_warmup`` is plain burn-in).
    ``algorithm="slice"`` runs slice-within-Gibbs — derivative-free with
    per-coordinate self-tuning brackets; prefer it over ``"stretch"`` at
    small ``n_chains`` or when walkers cannot span the dimension.
    ``algorithm="demcz"`` runs DE-MC(Z) — derivative-free with a tiny
    population (``n_chains`` maps to ``n_pop``, min 4): archive-based
    difference proposals span the space even when the walkers cannot.
    ``algorithm="pt"`` runs parallel tempering with a self-tuning
    geometric ladder — the one-call choice for MULTIMODAL posteriors
    (draws are the cold chain's; check
    ``diagnostics["round_trip_rate"] > 0``).
    ``algorithm="gibbs"`` runs compositional block-Gibbs and requires
    ``blocks=[(indices, method[, opts]), ...]`` (see
    :func:`mcmc_tpu.gibbs`) — per-block dual-averaging adaptation is on
    by default for rwmh/hmc blocks; with a pytree model the indices
    refer to the RAVELED flat vector (``diagnostics["unravel"]`` maps
    back), and exact-conditional callables receive the flat constrained
    vector.
    ``init="laplace"`` first finds the posterior mode
    (:func:`mcmc_tpu.map_laplace`, batched-Adam MAP) and starts every
    chain from an overdispersed draw of the Laplace Gaussian instead of
    ``initial_vals`` directly; ``init="pathfinder"`` instead starts chains
    from PSIS-resampled multi-path Pathfinder draws
    (:func:`mcmc_tpu.pathfinder` — L-BFGS-path variational approximation,
    targets the typical set rather than the mode; prefer it on
    non-Gaussian geometry and in high dimension where the Laplace Hessian
    is expensive). ``lower_bounds``/``upper_bounds`` (either
    or both, per-dimension, inf = unbounded) apply the same box-constraint
    transform stack as the sampler entry points.

    **Pytree models**: ``initial_vals`` may be a parameter pytree (e.g.
    ``{"mu": jnp.zeros(3), "sigma": 1.0}``) with ``log_kernel`` taking the
    same structure — fit ravels it onto the flat API automatically
    (:func:`ravel_model`); bounds may then be pytree prefixes or scalars
    (:func:`bounds_like`). ``diagnostics["unravel"]`` holds the
    flat->tree function; ``unravel_draws(out.draws,
    out.diagnostics["unravel"])`` restores structure.

    Run-until-converged: setting ``rhat_target`` (e.g. 1.01, checked
    against the max rank-normalized split R-hat) and/or ``min_ess``
    (checked against the min bulk ESS) keeps extending the run in warm
    ``n_draws``-sized segments — no re-warmup, adapted step size / mass /
    trajectory state carried — until the gates pass or ``max_rounds``
    segments have run. ``diagnostics["n_rounds"]`` and
    ``diagnostics["converged"]`` record the outcome; per-draw trace
    diagnostics reflect the final segment only.

    ``checkpoint_dir`` streams kept draws to the native draw sink and
    checkpoints sampler state so a killed fit resumes bit-identically
    (:mod:`mcmc_tpu.checkpoint`); it composes with the convergence gates —
    each extension round re-enters the same directory with a larger draw
    total, which the chunked runner treats as a seamless continuation of
    the same stream (only the new draws execute). ``thin=k`` advances
    ``k`` transitions per stored draw. All algorithms attach
    ``diagnostics["summary"]`` (mean, sd, MCSE, quantiles, HDI, split/rank
    R-hat, bulk/tail ESS) — computed from the draw-sink memmap in
    checkpointed runs. The "it just works" entry point the reference's
    fixed-settings API cannot offer.
    """
    if init not in (None, "laplace", "pathfinder"):
        raise ValueError(f"fit init must be None, 'laplace', or "
                         f"'pathfinder', got {init!r}")
    initial_vals, log_kernel, lower_bounds, upper_bounds, unravel = \
        _fit_ravel(initial_vals, log_kernel, lower_bounds, upper_bounds)
    extend = rhat_target is not None or min_ess is not None
    if (extend or init is not None) and key is None:
        key = jax.random.PRNGKey(0)
    bounded = lower_bounds is not None or upper_bounds is not None
    def _algo(inner):
        kw = dict(vals_bound=bounded, lower_bounds=lower_bounds,
                  upper_bounds=upper_bounds) if bounded else {}
        return AlgoSettings(**kw, **inner)
    if init == "laplace":
        key, k_map, k_init = jax.random.split(key, 3)
        lap = map_laplace(initial_vals, log_kernel, _algo({}), key=k_map)
        _laplace_init = lambda n: lap.draw_init(k_init, n)
    elif init == "pathfinder":
        key, k_pf, k_init = jax.random.split(key, 3)
        pf = pathfinder(initial_vals, log_kernel, _algo({}), key=k_pf,
                        n_draws=256)
        _laplace_init = lambda n: pf.draw_init(k_init, n)
    # Reserve a disjoint key for the sampler run: the extension loop below
    # keeps splitting `key`, and jax.random.split(k, 2) rows are a prefix of
    # split(k, n) rows, so handing the sampler the same `key` we later split
    # would exactly replay its internal streams in the extension segments.
    k_run = None
    if key is not None:
        key, k_run = jax.random.split(key)

    chain_algos = ("nuts", "chees", "hmc", "ghmc", "mala", "barker",
                   "slice", "mclmc", "mams", "pt", "gibbs")
    if algorithm == "gibbs" and blocks is None:
        raise ValueError(
            "fit(algorithm='gibbs') requires blocks=[(indices, method"
            "[, opts]), ...] — the block partition is the model "
            "structure only you know (see mcmc_tpu.gibbs)")
    if algorithm != "gibbs" and blocks is not None:
        raise ValueError(f"blocks= is gibbs-only, got "
                         f"algorithm={algorithm!r}")
    if algorithm in chain_algos and init is not None:
        initial_vals = _laplace_init(n_chains)
    ckpt = None if checkpoint_dir is None else str(checkpoint_dir)

    def _run(total_keep, want_resume):
        """One sampler invocation with ``total_keep`` kept draws. In
        checkpointed extension rounds ``total_keep`` grows while the
        directory stays fixed — the chunked runner resumes the stream."""
        kw = dict(key=k_run, mesh=mesh, checkpoint_dir=ckpt, thin=thin,
                  return_resume=want_resume)
        # fit is the "it just works" surface: gradient samplers use the
        # EXACT unconstrained-space gradient (grad of box kernel incl. the
        # log-Jacobian), not the reference's quirked bounded-gradient
        # convention — the quirk mis-shapes proposals near bounds (stuck
        # chains) and, for MALA, biases the stationary distribution
        # (samplers/mala.py module docstring). The direct entry points keep
        # the reference default for parity.
        grad_kw = dict(bounded_grad="exact")
        if algorithm == "chees":
            cs = ChEESSettings(n_burnin_draws=n_warmup,
                               n_keep_draws=total_keep)
            if target_accept is not None:
                cs.target_accept_rate = target_accept
            return chees(initial_vals, log_kernel,
                         _algo({"chees_settings": cs}), n_chains=n_chains,
                         adapt_mass_matrix="dense" if dense_mass else "diag",
                         **grad_kw, **kw)
        if algorithm == "nuts":
            s = NUTSSettings(
                n_burnin_draws=n_warmup, n_keep_draws=total_keep,
                n_adapt_draws=n_warmup,
                target_accept_rate=(0.8 if target_accept is None
                                    else target_accept),
                max_tree_depth=max_tree_depth,
            )
            # adapt_depth + static tree recap: the sampling kernel is
            # rebuilt with the warmup-learned depth budget as the static
            # tree size — ~2x draws/s at identical R-hat on the flagship
            # (samplers/nuts.py docstring); the recap changes the state
            # template's shape so it cannot compose with checkpoint_dir
            return nuts(initial_vals, log_kernel, _algo({"nuts_settings": s}),
                        n_chains=n_chains, pooled_adaptation=True,
                        adapt_mass_matrix="dense" if dense_mass else "diag",
                        adapt_depth=True,
                        static_sampling_depth=ckpt is None,
                        # cap the doubling budget during warmup's first
                        # (mis-adapted) half — measured ~1.7x faster
                        # time-to-posterior at identical adapted step size,
                        # learned budget, and moments (samplers/nuts.py);
                        # the second (histogram) half and sampling keep the
                        # full max_tree_depth. warmup_tree_depth=None
                        # disables (full reference-parity warmup).
                        warmup_tree_depth=(
                            None if warmup_tree_depth is None
                            else min(int(warmup_tree_depth),
                                     max_tree_depth)),
                        **grad_kw, **kw)
        if algorithm == "hmc":
            hs = HMCSettings(n_burnin_draws=n_warmup, n_keep_draws=total_keep,
                             n_leap_steps=int(n_leap_steps), step_size=0.1)
            return hmc(initial_vals, log_kernel, _algo({"hmc_settings": hs}),
                       n_chains=n_chains, adapt_step_size=True,
                       target_accept=target_accept,
                       adapt_mass_matrix="dense" if dense_mass else "diag",
                       **grad_kw, **kw)
        if algorithm == "ghmc":
            gs = GHMCSettings(n_burnin_draws=n_warmup,
                              n_keep_draws=total_keep)
            return ghmc(initial_vals, log_kernel,
                        _algo({"ghmc_settings": gs}), n_chains=n_chains,
                        adapt_step_size=True, target_accept=target_accept,
                        **grad_kw, **kw)
        if algorithm == "mala":
            ms = MALASettings(n_burnin_draws=n_warmup,
                              n_keep_draws=total_keep, step_size=0.1)
            return mala(initial_vals, log_kernel,
                        _algo({"mala_settings": ms}), n_chains=n_chains,
                        adapt_step_size=True, target_accept=target_accept,
                        adapt_precond="dense" if dense_mass else "diag",
                        pooled_adaptation=True, **grad_kw, **kw)
        if algorithm == "barker":
            if dense_mass:
                raise ValueError(
                    "fit(algorithm='barker') supports per-coordinate "
                    "(diagonal) scales only (dense_mass=False)")
            bs = BarkerSettings(n_burnin_draws=n_warmup,
                                n_keep_draws=total_keep, step_size=0.5)
            return barker(initial_vals, log_kernel,
                          _algo({"barker_settings": bs}), n_chains=n_chains,
                          adapt_step_size=True, target_accept=target_accept,
                          adapt_precond=True, pooled_adaptation=True, **kw)
        if algorithm in ("mclmc", "mams"):
            # the microcanonical family: mclmc = unadjusted (one gradient
            # per draw, O(eps^2) bias at the desired_energy_var operating
            # point), mams = Metropolis-exact. Cross-chain tuning pools
            # variances, so these shine at large n_chains. Preconditioning
            # is diagonal-only (the dynamics whiten coordinates directly).
            if dense_mass:
                raise ValueError(
                    f"fit(algorithm={algorithm!r}) supports diagonal "
                    "preconditioning only (dense_mass=False)")
            if algorithm == "mclmc":
                ms2 = MCLMCSettings(n_burnin_draws=n_warmup,
                                    n_keep_draws=total_keep)
                return mclmc(initial_vals, log_kernel,
                             _algo({"mclmc_settings": ms2}),
                             n_chains=n_chains, adapt_mass=True, **kw)
            as2 = MAMSSettings(n_burnin_draws=n_warmup,
                               n_keep_draws=total_keep)
            if target_accept is not None:
                as2.target_accept_rate = target_accept
            return mams(initial_vals, log_kernel,
                        _algo({"mams_settings": as2}),
                        n_chains=n_chains, adapt_mass=True, **kw)
        if algorithm == "gibbs":
            if dense_mass:
                raise ValueError(
                    "fit(algorithm='gibbs') has no dense mass — "
                    "preconditioning is per-block (pass per-block opts "
                    "via blocks=)")
            blocks_eff = blocks
            if target_accept is not None:
                # thread fit's target into every adapted MH block that
                # doesn't set its own (dropping it silently would be the
                # exact misdirected-option trap gibbs validates against)
                blocks_eff = []
                for spec in blocks:
                    method = spec[1]
                    opts = dict(spec[2]) if len(spec) == 3 else {}
                    if not callable(method) and method in ("rwmh", "hmc"):
                        opts.setdefault("target_accept", target_accept)
                    blocks_eff.append((spec[0], method, opts) if opts
                                      else (spec[0], method))
            gs = GibbsSettings(n_burnin_draws=n_warmup,
                               n_keep_draws=total_keep)
            return gibbs(initial_vals, log_kernel,
                         _algo({"gibbs_settings": gs}), blocks=blocks_eff,
                         n_chains=n_chains, **kw)
        if algorithm == "pt":
            # one-call multimodal fit: parallel tempering with a
            # self-tuning geometric ladder; draws are the cold chain's
            ps = PTSettings(n_burnin_draws=n_warmup, n_keep_draws=total_keep,
                            adapt_temps=True)
            return pt(initial_vals, log_kernel, _algo({"pt_settings": ps}),
                      n_chains=n_chains, **kw)
        if algorithm == "slice":
            sls = SliceSettings(n_burnin_draws=n_warmup,
                                n_keep_draws=total_keep)
            return slice_sampler(initial_vals, log_kernel,
                                 _algo({"slice_settings": sls}),
                                 n_chains=n_chains, **kw)
        if algorithm == "stretch":
            import numpy as _np
            dim = int(_np.asarray(initial_vals).shape[-1])
            n_walkers = max(int(n_chains), 2 * dim, 32)
            n_walkers += n_walkers % 2
            if mesh is not None:   # two shardable halves per device
                m = 2 * int(_np.prod(list(mesh.shape.values())))
                n_walkers = ((n_walkers + m - 1) // m) * m
            ss = StretchSettings(n_walkers=n_walkers, n_burnin_draws=n_warmup,
                                 n_keep_draws=total_keep)
            iv = initial_vals
            if init == "laplace":
                # ensemble centers on the MAP with curvature-matched spread
                # (the walker ball lives in unconstrained space, as does cov)
                iv = lap.mode
                ss.init_spread = jnp.sqrt(jnp.diagonal(lap.cov))
            elif init == "pathfinder":
                # ensemble centers on the draw-cloud mean with its own
                # spread (both from the unconstrained pathfinder draws)
                iv = pf.center
                ss.init_spread = pf.spread_z
            return stretch(iv, log_kernel, _algo({"stretch_settings": ss}),
                           **kw)
        if algorithm == "demcz":
            if mesh is not None:
                raise ValueError(
                    "fit(algorithm='demcz') does not take mesh: the "
                    "population is deliberately tiny (scale by replicating "
                    "runs instead)")
            zs = DEMCZSettings(n_pop=max(int(n_chains), 4),
                               n_burnin_draws=n_warmup,
                               n_keep_draws=total_keep)
            iv = initial_vals
            if init == "laplace":
                # center the initial box on the MAP with curvature-matched
                # half-width; init_box builds it in unconstrained space
                # (where lap.cov lives) and maps back, so bounded parameters
                # get a correctly scaled constrained-space box
                iv = lap.mode
                zs.initial_lb, zs.initial_ub = lap.init_box(2.0)
            elif init == "pathfinder":
                # initial box spans the pathfinder draw cloud
                iv = pf.center
                zs.initial_lb, zs.initial_ub = pf.init_box(2.0)
            kw.pop("mesh")
            return demcz(iv, log_kernel, _algo({"demcz_settings": zs}), **kw)
        raise ValueError(
            f"fit algorithm must be 'nuts', 'chees', 'hmc', 'ghmc', "
            f"'mala', 'barker', 'mclmc', 'mams', 'pt', 'gibbs', "
            f"'stretch', 'slice', or 'demcz', got {algorithm!r}")

    def _gates_ok(d):
        ok = (rhat_target is None
              or float(diagnostics.rank_normalized_rhat(d).max())
              <= rhat_target)
        if ok and min_ess is not None:
            ok = float(diagnostics.bulk_ess(d).min()) >= min_ess
        return ok

    if not extend:
        out = _run(n_draws, False)
    elif ckpt is not None:
        # checkpointed extension: re-enter the same directory with a grown
        # total — the chunked runner resumes the carried key/state stream,
        # so each round computes only the new draws (bit-identical to one
        # long run); gates evaluate the full sink contents
        rounds = 1
        while True:
            out = _run(n_draws * rounds, False)
            d = jnp.asarray(out.draws)
            ok = _gates_ok(d)
            if ok or rounds >= max_rounds:
                break
            rounds += 1
        out.diagnostics["n_rounds"] = rounds
        out.diagnostics["converged"] = ok
    else:
        out = _run(n_draws, True)
        resume = out.diagnostics.pop("resume")
        segs, accepts, rounds = [out.draws], [out.n_accept_draws], 1
        while True:
            d = jnp.concatenate(segs, axis=0) if len(segs) > 1 else segs[0]
            ok = _gates_ok(d)
            if ok or rounds >= max_rounds:
                break
            key, k_ext = jax.random.split(key)
            out = resume(k_ext, n_draws)
            resume = out.diagnostics.pop("resume")
            segs.append(out.draws)
            accepts.append(out.n_accept_draws)
            rounds += 1
        n_acc = accepts[0]
        for a in accepts[1:]:
            n_acc = n_acc + a
        out = SamplerResult(
            draws=d, n_accept_draws=n_acc,
            diagnostics={**out.diagnostics, "n_rounds": rounds,
                         "converged": ok})
    if unravel is not None:
        out.diagnostics["unravel"] = unravel
    out.diagnostics["summary"] = diagnostics.summary(out.draws)
    return out

__all__ = [
    "rwmh", "mala", "hmc", "nuts", "chees", "rmhmc", "de", "demcz", "aees",
    "pt", "smc", "stretch", "sgld", "sghmc", "elliptical_slice",
    "slice_sampler", "mclmc", "mams", "barker", "mmala",
    "sample", "fit", "map_laplace", "LaplaceResult",
    "thermo_evidence", "EvidenceResult", "EvidenceSettings",
    "pathfinder", "PathfinderResult",
    "nested_sampling", "NestedResult",
    "advi", "ADVIResult",
    "svgd", "SVGDResult",
    "AlgoSettings", "RWMHSettings", "MALASettings", "HMCSettings",
    "NUTSSettings", "ChEESSettings", "RMHMCSettings", "DESettings",
    "DEMCZSettings", "AEESSettings", "PTSettings", "SMCSettings",
    "StretchSettings",
    "SGLDSettings", "SGHMCSettings", "EllipticalSettings", "SliceSettings",
    "MCLMCSettings", "MAMSSettings", "BarkerSettings", "MMALASettings",
    "SamplerResult", "bounds", "stats", "diagnostics", "models",
    "pointwise_log_lik", "waic", "psis_loo", "compare",
    "ravel_model", "unravel_draws", "bounds_like", "softabs_metric",
    "generated_quantities", "posterior_predictive", "sbc",
]
