"""Typed per-sampler settings.

Field names and defaults carry over 1:1 from the reference's settings structs
(reference include/misc/mcmc_structs.hpp:26-184) so reference example configs
translate mechanically. The reference's OpenMP thread-count field
(``omp_n_threads``) has no analog: on-chip parallelism here is the vmapped
``n_chains`` axis and multi-chip parallelism is the device mesh (see
``mcmc_tpu.parallel``); both are arguments to the sampler entry points.

All settings are plain Python dataclasses holding static (trace-time)
configuration; array-valued fields (covariances, bounds, temperature ladders)
may be any array-like.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = [
    "RWMHSettings", "MALASettings", "HMCSettings", "NUTSSettings",
    "ChEESSettings", "RMHMCSettings", "DESettings", "AEESSettings",
    "PTSettings", "SMCSettings", "StretchSettings", "SGLDSettings",
    "SGHMCSettings", "DEMCZSettings", "MCLMCSettings", "MAMSSettings",
    "BarkerSettings", "MMALASettings", "EvidenceSettings", "AlgoSettings",
]

ArrayLike = Any


@dataclass
class RWMHSettings:
    """Random-walk Metropolis-Hastings (reference mcmc_structs.hpp:138-149).

    ``dr_shrink`` (beyond-reference) scales the second-stage fallback
    proposal when ``rwmh(delayed_rejection=True)`` — see samplers/rwmh.py."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    par_scale: float = 1.0
    cov_mat: Optional[ArrayLike] = None  # None -> identity
    dr_shrink: float = 0.2               # delayed-rejection stage-2 scale


@dataclass
class MALASettings:
    """Metropolis-adjusted Langevin (reference mcmc_structs.hpp:123-134)."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    step_size: float = 1.0
    precond_mat: Optional[ArrayLike] = None  # None -> identity


@dataclass
class HMCSettings:
    """Hamiltonian Monte Carlo (reference mcmc_structs.hpp:66-78)."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    n_leap_steps: int = 1
    step_size: float = 1.0
    precond_mat: Optional[ArrayLike] = None


@dataclass
class GHMCSettings:
    """Generalized HMC with persistent momentum (Horowitz 1991; no
    reference analog — one gradient per draw with HMC-like coherent
    motion, see samplers/ghmc.py). ``momentum_persistence`` is alpha in
    [0, 1) (0.0 = auto ``exp(-step_size/sqrt(dim))`` from the NOMINAL
    step size — with ``adapt_step_size=True`` dual averaging may move
    eps away from it, so set alpha explicitly when adapting); ``jitter``
    scales the step size uniformly in ``[(1-jitter) eps, eps]`` per
    draw per chain to break partial-refresh resonances (the MEADS
    prescription, Hoffman & Sountsov 2022)."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    n_leap_steps: int = 1
    step_size: float = 0.25
    momentum_persistence: float = 0.0   # 0.0 = auto
    jitter: float = 0.2
    precond_mat: Optional[ArrayLike] = None


@dataclass
class ChEESSettings:
    """ChEES-HMC: adaptive shared-trajectory HMC (no reference analog —
    Hoffman, Radul & Sountsov 2021; the framework's accelerator-native
    alternative to NUTS, see samplers/chees.py)."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    step_size: float = 0.1           # initial; dual averaging tunes it
    init_leap_steps: int = 10        # T_0 = step_size * init_leap_steps
    max_leap_steps: int = 1000       # hard per-draw trajectory cap
    target_accept_rate: float = 0.651
    adam_learning_rate: float = 0.025


@dataclass
class NUTSSettings:
    """No-U-Turn sampler with dual-averaging step-size adaptation
    (reference mcmc_structs.hpp:82-101)."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    n_adapt_draws: int = 1000
    target_accept_rate: float = 0.55
    max_tree_depth: int = 10
    step_size: float = 1.0       # epsilon_bar_0
    gamma_val: float = 0.05
    t0_val: float = 10.0
    kappa_val: float = 0.75
    precond_mat: Optional[ArrayLike] = None


@dataclass
class RMHMCSettings:
    """Riemannian-manifold HMC with fixed-point generalized leapfrog
    (reference mcmc_structs.hpp:105-119)."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    n_leap_steps: int = 1
    step_size: float = 1.0
    precond_mat: Optional[ArrayLike] = None
    n_fp_steps: int = 5


@dataclass
class DESettings:
    """Differential-evolution MCMC (reference mcmc_structs.hpp:44-62).

    Note: as in the reference, the running gamma is the hard-coded optimal
    ``2.38 / sqrt(2 d)`` (reference src/de.cpp:59-60); ``par_gamma`` is kept
    for interface parity but unused, and ``par_gamma_jump`` applies on every
    10th sweep when ``jumps`` is on (src/de.cpp:151-153).
    """
    jumps: bool = False
    n_pop: int = 100
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    par_b: float = 1e-4
    par_gamma: float = 1.0
    par_gamma_jump: float = 2.0
    initial_lb: Optional[ArrayLike] = None  # None -> initial_vals - 0.5
    initial_ub: Optional[ArrayLike] = None  # None -> initial_vals + 0.5


@dataclass
class DEMCZSettings:
    """DE-MC(Z) — archive-based differential evolution with snooker moves
    (ter Braak & Vrugt 2008; no reference analog — the small-population
    member of the gradient-free family beside DESettings, see
    samplers/demcz.py).

    ``n_pop`` may be far below the dimension (>= 4): proposals difference
    *archive* states, not current walkers.  ``snooker_prob`` is the
    per-walker probability of the snooker (line) move; the rest use the
    parallel-direction move with the DE-optimal ``2.38 / sqrt(2 d)`` (and
    ``par_gamma_jump`` every 10th generation when ``jumps``, as in
    DESettings).  The population is appended to the archive every
    ``archive_stride`` generations.  ``archive_size=None`` sizes the buffer
    to hold every append exactly (the paper's growing archive); an explicit
    value makes it a ring overwriting the oldest entries (bounded memory).
    ``n_initial_archive=None`` -> ``max(n_pop, 10 * n_vals)`` uniform draws
    from the initial box (the archive must span the space)."""
    n_pop: int = 8
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    snooker_prob: float = 0.1
    jumps: bool = True
    par_gamma_jump: float = 1.0
    par_b: float = 1e-4
    archive_stride: int = 10
    archive_size: Optional[int] = None
    n_initial_archive: Optional[int] = None
    initial_lb: Optional[ArrayLike] = None  # None -> initial_vals - 0.5
    initial_ub: Optional[ArrayLike] = None  # None -> initial_vals + 0.5


@dataclass
class AEESSettings:
    """Adaptive equi-energy sampler (reference mcmc_structs.hpp:26-40)."""
    n_initial_draws: int = 1000
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    par_scale: float = 1.0
    cov_mat: Optional[ArrayLike] = None
    n_rings: int = 5
    ee_prob_par: float = 0.10
    temper_vec: Optional[ArrayLike] = None  # user ladder; T=1 appended


@dataclass
class PTSettings:
    """Parallel tempering / replica exchange (no reference analog — the
    classic multimodal sampler the reference's AEES approximates; see
    samplers/pt.py). A ladder of replicas targets ``beta_k * log_kernel``
    with HMC or RWMH inner moves; adjacent replicas attempt even/odd
    state swaps — a pure masked index permutation on the device, no host
    sync."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    temper_vec: Optional[ArrayLike] = None  # user ladder; T=1 appended
    n_temps: int = 8                 # geometric ladder when temper_vec=None
    max_temp: float = 100.0
    inner: str = "hmc"               # "hmc" | "rwmh" inner transition
    step_size: float = 0.1           # inner HMC step at T=1 (scaled sqrt(T))
    n_leap_steps: int = 8
    par_scale: float = 1.0           # inner RWMH scale at T=1 (scaled sqrt(T))
    cov_mat: Optional[ArrayLike] = None
    swap_every: int = 1              # attempt swaps every N sweeps
    adapt_temps: bool = False        # Robbins-Monro ladder adaptation
    n_adapt_draws: Optional[int] = None   # defaults to n_burnin_draws
    target_swap_accept: float = 0.234


@dataclass
class SMCSettings:
    """Adaptive tempered Sequential Monte Carlo (no reference analog — the
    population-native completion of the reference's DE/AEES family; see
    samplers/smc.py). Anneals a particle cloud from ``N(initial_vals,
    diag(init_scale^2))`` to the posterior with an ESS-adaptive temperature
    schedule, resampling, and population-preconditioned mutation; also
    estimates the log normalizing constant."""
    n_particles: int = 4096
    ess_target: float = 0.5          # incremental-ESS fraction per stage
    max_stages: int = 100
    n_mcmc_steps: int = 5            # mutation moves per particle per stage
    inner: str = "rwmh"              # "rwmh" | "hmc" mutation kernel
    par_scale: float = 1.0           # rwmh: scales 2.38/sqrt(d) * pop-chol
    step_size: float = 0.5           # hmc: step in population-std units
    n_leap_steps: int = 5
    init_scale: ArrayLike = 1.0      # scalar or (n_vals,) q0 std dev
    resample: str = "systematic"     # | "stratified" | "multinomial"


@dataclass
class StretchSettings:
    """Affine-invariant ensemble sampler, Goodman & Weare (2010) stretch
    move (no reference analog — completes the gradient-free population
    family beside DESettings; see samplers/stretch.py). ``par_a`` is the
    stretch scale (proposal support ``z in [1/a, a]``); ``init_spread`` the
    Gaussian-ball radius of the initial ensemble around ``initial_vals`` on
    the unconstrained space. ``n_walkers`` must be even and >= 2 * n_vals."""
    n_walkers: int = 100
    par_a: float = 2.0
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    init_spread: ArrayLike = 0.5


@dataclass
class SGLDSettings:
    """Stochastic-gradient Langevin dynamics (Welling & Teh 2011; no
    reference analog — the minibatch member of the gradient family, see
    samplers/sgld.py). ``step_size`` is the initial ``h``;
    ``decay_gamma > 0`` enables the polynomial schedule
    ``h_t = step_size * (decay_b / (decay_b + t)) ** decay_gamma``;
    ``batch_size`` rows are gathered per draw per chain (uniform with
    replacement); ``precond_mat`` is a fixed diagonal/dense preconditioner
    M (same convention as MALASettings.precond_mat).
    ``rmsprop_alpha``/``rmsprop_lambda`` parameterize the pSGLD
    preconditioner when ``sgld(..., adapt_precond='rmsprop')`` (Li et al.
    2016 defaults)."""
    step_size: float = 1e-4
    batch_size: int = 256
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    decay_gamma: float = 0.0
    decay_b: float = 1.0
    precond_mat: Optional[ArrayLike] = None
    rmsprop_alpha: float = 0.99
    rmsprop_lambda: float = 1e-5


@dataclass
class SGHMCSettings:
    """Stochastic-gradient HMC (Chen, Fox & Guestrin 2014; no reference
    analog — see samplers/sgld.py). The paper's practical SGD-with-momentum
    form: ``v <- (1 - friction_alpha) v + step_size * g + N(0,
    2 (friction_alpha - beta_hat) step_size)``, ``x <- x + v``.
    ``step_size`` is the paper's eta (learning rate, = discretization h^2);
    ``friction_alpha`` the momentum decay per step; ``beta_hat`` an
    optional estimate of the minibatch-gradient noise half-variance
    (0 = ignore, the paper's default)."""
    step_size: float = 1e-5
    friction_alpha: float = 0.1
    beta_hat: float = 0.0
    batch_size: int = 256
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000


@dataclass
class SliceSettings:
    """Univariate slice sampling within Gibbs (Neal 2003; no reference
    analog — the self-tuning gradient-free chain sampler, see
    samplers/slice.py). ``w`` is the initial bracket width (scalar or
    per-dimension) — the only scale knob, and it self-corrects: a wrong
    ``w`` costs a few extra kernel evaluations per coordinate, not
    statistical efficiency. ``max_step_out`` bounds the stepping-out
    expansion (Neal's m, the budget split randomly between the sides);
    ``max_shrink_steps`` caps the shrinkage loop (a safety net — a capped
    coordinate keeps its value and the draw reports as not accepted)."""
    w: ArrayLike = 1.0
    max_step_out: int = 8
    max_shrink_steps: int = 32
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000


@dataclass
class GibbsSettings:
    """Compositional block-Gibbs (no reference analog — kernel composition
    over parameter blocks, see samplers/gibbs.py). The block structure and
    per-block tuning live in the ``blocks=`` argument of
    :func:`mcmc_tpu.gibbs` — they are model structure, not global knobs;
    only the sweep counts live here."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000


@dataclass
class EllipticalSettings:
    """Elliptical slice sampling (Murray, Adams & MacKay 2010; no reference
    analog — the tuning-free latent-Gaussian sampler, see
    samplers/ellipse.py). The Gaussian prior is passed to
    ``elliptical_slice`` directly (``prior_mean=``/``prior_cov=``), not
    here — it is model structure, not a tuning knob; there are no tuning
    knobs. ``max_shrink_steps`` caps the bracket-shrinking loop
    (termination is guaranteed in exact arithmetic; the cap is a safety
    net — a capped draw stays in place and reports as not accepted)."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    max_shrink_steps: int = 64


@dataclass
class MCLMCSettings:
    """Unadjusted Microcanonical Langevin Monte Carlo (Robnik, De Luca,
    Silverstein & Seljak 2022, arXiv:2212.08549; no reference analog — the
    framework's highest-throughput accelerator-native sampler, see
    samplers/mclmc.py). One gradient per draw, no accept/reject; the
    stationary distribution carries an O(step_size^2) discretization bias
    controlled by ``desired_energy_var``.

    ``L`` is the momentum-decoherence length (0.0 = auto: init sqrt(dim),
    then adapted to ``l_factor * sqrt(trace posterior covariance)`` from
    pooled cross-chain variances during burn-in). ``step_size`` is tuned
    during burn-in so the pooled per-dimension squared energy error per
    step hits ``desired_energy_var``."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    step_size: float = 0.0          # 0.0 = auto (init from L / 10)
    L: float = 0.0                  # 0.0 = auto
    desired_energy_var: float = 5e-4
    l_factor: float = 1.0
    variance_ema_rate: float = 0.02  # cross-chain variance EWMA gain
    integrator: str = "mclachlan"   # minimal-norm (default) | "velocity_verlet"


@dataclass
class MAMSSettings:
    """Metropolis-adjusted microcanonical sampler (Robnik & Seljak 2024; no
    reference analog — exact chain built on the isokinetic integrator, see
    samplers/mclmc.py). Full momentum refresh + a jittered isokinetic
    trajectory per draw, accepted on the microcanonical energy error.
    Trajectory length T = ``l_factor * sqrt(trace posterior covariance)``
    (adapted from pooled cross-chain variances; 0.0 = auto), jittered per
    draw by a shared Halton point like ChEES; step size dual-averaged to
    ``target_accept_rate`` (0.9 — isokinetic energy errors are lighter-
    tailed than Hamiltonian ones, so the optimum sits higher than HMC's)."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    step_size: float = 0.0          # 0.0 = auto
    L: float = 0.0                  # 0.0 = auto (trajectory length scale)
    target_accept_rate: float = 0.9
    max_leap_steps: int = 1024      # hard per-draw trajectory cap
    l_factor: float = 1.0
    variance_ema_rate: float = 0.02
    integrator: str = "mclachlan"   # minimal-norm (default) | "velocity_verlet"


@dataclass
class MMALASettings:
    """Simplified manifold MALA (Girolami & Calderhead 2011; no reference
    analog — the one-step sibling of RMHMCSettings; see samplers/mmala.py).
    Position-dependent Langevin proposals under a user metric (or
    softabs_metric), exact via the two-sided MH correction."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    step_size: float = 0.2


@dataclass
class BarkerSettings:
    """Barker proposal (Livingstone & Zanella 2022; no reference analog —
    the robust gradient-based alternative to MALASettings; see
    samplers/barker.py). The gradient skews the sign of a symmetric
    Gaussian kick instead of shifting its mean, so the chain stays
    geometrically ergodic where MALA is transient and tolerates step-size
    mis-tuning."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    step_size: float = 0.5


@dataclass
class EvidenceSettings:
    """Power-posterior marginal-likelihood estimation (no reference analog —
    MCMCLib cannot produce ``log Z``; see evidence.py). A ``n_temps``-rung
    replica-exchange ladder targets ``prior·lik^beta`` with
    ``beta_k = (k/(K-1))^schedule_power`` (Friel & Pettitt 2008), DEO
    even/odd swaps, and per-rung dual-averaged step sizes."""
    n_burnin_draws: int = 1000
    n_keep_draws: int = 1000
    n_temps: int = 24
    schedule_power: float = 5.0
    inner: str = "hmc"               # "hmc" | "rwmh" inner transition
    step_size: float = 0.25          # hmc initial per-rung step size
    n_leap_steps: int = 8
    par_scale: float = 0.5           # rwmh initial per-rung proposal sd
    target_accept: Optional[float] = None  # default 0.65 hmc / 0.234 rwmh
    swap_every: int = 1
    n_adapt_draws: Optional[int] = None    # defaults to n_burnin_draws


@dataclass
class AlgoSettings:
    """Umbrella settings (reference mcmc_structs.hpp:151-184).

    ``rng_seed_value`` seeds the counter-based JAX PRNG (the analog of the
    reference's ``std::mt19937_64`` master engine, mcmc_options.hpp:101);
    per-chain streams come from ``jax.random.split`` rather than the
    reference's derived per-thread seeds (stats/seed_values.hpp:24-30).
    """
    rng_seed_value: int = 0
    vals_bound: bool = False
    lower_bounds: Optional[ArrayLike] = None
    upper_bounds: Optional[ArrayLike] = None

    rwmh_settings: RWMHSettings = field(default_factory=RWMHSettings)
    mala_settings: MALASettings = field(default_factory=MALASettings)
    hmc_settings: HMCSettings = field(default_factory=HMCSettings)
    ghmc_settings: GHMCSettings = field(default_factory=GHMCSettings)
    nuts_settings: NUTSSettings = field(default_factory=NUTSSettings)
    chees_settings: ChEESSettings = field(default_factory=ChEESSettings)
    rmhmc_settings: RMHMCSettings = field(default_factory=RMHMCSettings)
    de_settings: DESettings = field(default_factory=DESettings)
    demcz_settings: DEMCZSettings = field(default_factory=DEMCZSettings)
    aees_settings: AEESSettings = field(default_factory=AEESSettings)
    pt_settings: PTSettings = field(default_factory=PTSettings)
    smc_settings: SMCSettings = field(default_factory=SMCSettings)
    stretch_settings: StretchSettings = field(default_factory=StretchSettings)
    sgld_settings: SGLDSettings = field(default_factory=SGLDSettings)
    sghmc_settings: SGHMCSettings = field(default_factory=SGHMCSettings)
    elliptical_settings: EllipticalSettings = field(
        default_factory=EllipticalSettings)
    slice_settings: SliceSettings = field(default_factory=SliceSettings)
    gibbs_settings: GibbsSettings = field(default_factory=GibbsSettings)
    mclmc_settings: MCLMCSettings = field(default_factory=MCLMCSettings)
    mams_settings: MAMSSettings = field(default_factory=MAMSSettings)
    evidence_settings: EvidenceSettings = field(
        default_factory=EvidenceSettings)
    barker_settings: BarkerSettings = field(default_factory=BarkerSettings)
    mmala_settings: MMALASettings = field(default_factory=MMALASettings)

    def replace(self, **kw) -> "AlgoSettings":
        return dataclasses.replace(self, **kw)
