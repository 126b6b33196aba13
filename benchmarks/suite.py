#!/usr/bin/env python
"""Benchmark suite over every BASELINE.md config:

  1. RWMH on the 2-d Gaussian mean/scale model
  2. MALA + HMC (autodiff gradients) on Bayesian logistic regression
     (+ the fused-Pallas GLM path, logistic and probit links)
  3. NUTS on the 100-d ill-conditioned Gaussian and the banana
     (+ the fused-Pallas multivariate-Gaussian path on the same target)
  4. DE-MCMC on a multimodal Gaussian mixture
  5. AEES + PT + RM-HMC on multimodal / (mu, sigma) posteriors

For each: wall-clock, chain-draws/sec, min ESS/sec, and the full modern
diagnostics set — max split R-hat, max rank-normalized R-hat (the
convergence gate, <= 1.01), min bulk/tail ESS per second (Vehtari et al.
2021). Prints one JSON line per config plus a trailing summary line. The
primary single-line metric remains bench.py; this suite is the breadth
harness (SURVEY.md §7 step 8).

It needs a GPU and stops when JAX finds none; ``--cpu`` is an explicit CPU
rehearsal (pair it with ``--quick``), which leaves out the two fused-GLM
configs because their Pallas kernel compiles only for the GPU.
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def run_all(quick=False, out_path=None, platform="gpu"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import mcmc_tpu
    from mcmc_tpu import models, diagnostics
    from mcmc_tpu.device import enable_compile_cache, require_accelerator

    enable_compile_cache()
    dev = require_accelerator(platform)
    scale = 4 if quick else 1
    # --quick also scales chain/replica counts down (a smoke run doesn't
    # need the full-strength batches)
    C = (lambda n: max(n // 16, 8)) if quick else (lambda n: n)
    results = []

    def record(name, fn):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out.draws)
        el = time.perf_counter() - t0
        d = out.draws if out.draws.ndim == 3 else out.draws[:, None, :]
        # chunked-FFT ESS for large chain batches: the one-shot FFT's padded
        # complex temporaries grow with the chain count even where the
        # draws themselves fit (identical numerics, see diagnostics.ess)
        cc = 256 if d.shape[1] > 256 and d.shape[1] % 256 == 0 else None
        row = {
            "config": name,
            "seconds": round(el, 2),
            "chain_draws_per_sec": round(d.shape[0] * d.shape[1] / el, 1),
            "min_ess_per_sec": round(
                float(diagnostics.ess(d, chain_chunk=cc).min()) / el, 1),
            "max_split_rhat": round(float(diagnostics.split_rhat(d).max()), 4),
            "max_rank_rhat": round(
                float(diagnostics.rank_normalized_rhat(d).max()), 4),
            "min_bulk_ess_per_sec": round(
                float(diagnostics.bulk_ess(d, chain_chunk=cc).min()) / el, 1),
            "min_tail_ess_per_sec": round(
                float(diagnostics.tail_ess(d, chain_chunk=cc).min()) / el, 1),
        }
        results.append(row)
        print(json.dumps(row), flush=True)

    key = jax.random.PRNGKey(0)

    # 1. RWMH, 2-d Gaussian mean/scale
    x2 = 2.0 + 2.0 * jax.random.normal(key, (1000,))
    lk_ms = models.gaussian_mean_scale_model(x2)
    record("rwmh_gaussian_2d", lambda: mcmc_tpu.rwmh(
        jnp.array([2.0, 2.0]), lk_ms,
        mcmc_tpu.RWMHSettings(n_burnin_draws=2000 // scale,
                              n_keep_draws=4000 // scale, par_scale=0.1),
        n_chains=C(256), key=jax.random.PRNGKey(1)))

    # 2. MALA + HMC, logistic regression (jax.grad = the autodiff path)
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(2), 500, 25)
    lk_lr = models.logistic_regression_model(X, y)
    record("mala_logreg_25d", lambda: mcmc_tpu.mala(
        jnp.zeros(25), lk_lr,
        mcmc_tpu.MALASettings(n_burnin_draws=1000 // scale,
                              n_keep_draws=2000 // scale, step_size=0.05),
        n_chains=C(256), key=jax.random.PRNGKey(3), adapt_step_size=True))
    record("barker_logreg_25d", lambda: mcmc_tpu.barker(
        jnp.zeros(25), lk_lr,
        mcmc_tpu.BarkerSettings(n_burnin_draws=1000 // scale,
                                n_keep_draws=2000 // scale, step_size=0.5),
        n_chains=C(256), key=jax.random.PRNGKey(23), adapt_step_size=True,
        adapt_precond=True, pooled_adaptation=True))
    record("ghmc_logreg_25d", lambda: mcmc_tpu.ghmc(
        jnp.zeros(25), lk_lr,
        mcmc_tpu.GHMCSettings(n_burnin_draws=1000 // scale,
                              n_keep_draws=2000 // scale,
                              momentum_persistence=0.95),
        n_chains=C(256), key=jax.random.PRNGKey(29)))
    record("hmc_logreg_25d", lambda: mcmc_tpu.hmc(
        jnp.zeros(25), lk_lr,
        mcmc_tpu.HMCSettings(n_burnin_draws=1000 // scale,
                             n_keep_draws=2000 // scale,
                             step_size=0.1, n_leap_steps=8),
        n_chains=C(256), key=jax.random.PRNGKey(4), adapt_step_size=True,
        adapt_mass_matrix=True))

    # 2b. fused GLM path: the same logistic posterior through the fused
    # Pallas trajectory at a large batch, and the probit link
    # (non-canonical; beyond the reference's capability). The kernel
    # compiles only for the GPU, so a CPU rehearsal leaves these out.
    from mcmc_tpu.ops import fused_glm_hmc
    fchains = C(2048)
    if dev.platform == "gpu":
        record("hmc_logreg_25d_fused", lambda: fused_glm_hmc(
            X, y, step_size=0.08, n_leap=8, n_chains=fchains,
            n_burnin_draws=1000 // scale, n_keep_draws=2000 // scale,
            key=jax.random.PRNGKey(17)))
        yp = (jax.random.uniform(jax.random.PRNGKey(18), (500,)) <
              0.5 * (1.0 + jax.lax.erf((X @ jnp.full(25, 0.4)) / jnp.sqrt(2.0)))
              ).astype(jnp.float32)
        record("hmc_probit_25d_fused", lambda: fused_glm_hmc(
            X, yp, link="probit", step_size=0.08, n_leap=8, n_chains=fchains,
            n_burnin_draws=1000 // scale, n_keep_draws=2000 // scale,
            key=jax.random.PRNGKey(19)))

    # 3. NUTS, 100-d ill-conditioned + banana, 1024 chains.
    lk_ill = models.ill_conditioned_gaussian(100, 1e4)
    record("nuts_ill_conditioned_100d", lambda: mcmc_tpu.nuts(
        jnp.zeros(100), lk_ill,
        mcmc_tpu.NUTSSettings(n_burnin_draws=600 // scale,
                              n_keep_draws=600 // scale,
                              n_adapt_draws=600 // scale),
        n_chains=C(1024), key=jax.random.PRNGKey(5),
        adapt_mass_matrix=True, pooled_adaptation=True, adapt_depth=True))
    record("nuts_banana", lambda: mcmc_tpu.nuts(
        jnp.zeros(2), models.banana_model(b=0.1, sigma=3.0),
        mcmc_tpu.NUTSSettings(n_burnin_draws=800 // scale,
                              n_keep_draws=1600 // scale,
                              n_adapt_draws=800 // scale,
                              target_accept_rate=0.8),
        n_chains=C(1024), key=jax.random.PRNGKey(6), adapt_mass_matrix="dense"))

    # 3a'. batched multivariate-Gaussian HMC on the ill-conditioned
    # target: identity mass + long JITTERED-step trajectories carry the
    # slow directions. eps < 2 * sigma_min = 2 for stability; 0.9 x 157
    # leapfrogs spans ~pi/2 periods of the slowest (sigma = 100) mode; the
    # +-30% per-draw step jitter breaks the fixed-angle resonances an exact
    # quadratic otherwise hits (measured rank R-hat 3.2 unjittered -> 1.00);
    # steps_per_draw=2 halves the stored autocorrelation at constant memory.
    from mcmc_tpu.ops import fused_gaussian_hmc
    record("hmc_ill_conditioned_100d_fused", lambda: fused_gaussian_hmc(
        1.0 / lk_ill.variances, step_size=0.9, n_leap=157, n_chains=fchains,
        n_burnin_draws=600 // scale, n_keep_draws=600 // scale,
        init_scale=1.0, step_jitter=0.3, steps_per_draw=2,
        key=jax.random.PRNGKey(20)))

    # 3b. ChEES (beyond-reference) on the ill-conditioned target (1024
    # chains: its cross-chain trajectory criterion is built for the batch)
    record("chees_ill_conditioned_100d", lambda: mcmc_tpu.chees(
        jnp.zeros(100), lk_ill,
        mcmc_tpu.ChEESSettings(n_burnin_draws=600 // scale,
                               n_keep_draws=600 // scale),
        n_chains=C(1024), key=jax.random.PRNGKey(10), adapt_mass_matrix=True))

    # 3c. the microcanonical family (beyond-reference, round 4) on the same
    # target: mclmc = unadjusted (one gradient per step, thin=4 per the
    # protocol probe), mams = Metropolis-exact. 1024 chains — their
    # cross-chain (L, step-size) tuning and lockstep cost profile are built
    # for large batches.
    record("mclmc_ill_conditioned_100d", lambda: mcmc_tpu.mclmc(
        jnp.zeros(100), lk_ill,
        mcmc_tpu.MCLMCSettings(n_burnin_draws=600 // scale,
                               n_keep_draws=600 // scale),
        n_chains=C(1024), key=jax.random.PRNGKey(24), adapt_mass=True, thin=4))
    record("mams_ill_conditioned_100d", lambda: mcmc_tpu.mams(
        jnp.zeros(100), lk_ill,
        mcmc_tpu.MAMSSettings(n_burnin_draws=600 // scale,
                              n_keep_draws=600 // scale),
        n_chains=C(1024), key=jax.random.PRNGKey(25), adapt_mass=True))

    # 4. DE, multimodal mixture
    mu = jnp.array([[-2.0, -2.0], [2.0, 2.0]])
    lk_mix = models.gaussian_mixture_model(mu, jnp.array([0.5, 0.5]),
                                           jnp.array([0.5, 0.5]))
    record("de_mixture", lambda: mcmc_tpu.de(
        jnp.zeros(2), lk_mix,
        mcmc_tpu.DESettings(n_pop=200, n_burnin_draws=1000 // scale,
                            n_keep_draws=2000 // scale,
                            initial_lb=jnp.array([-4.0, -4.0]),
                            initial_ub=jnp.array([4.0, 4.0])),
        key=jax.random.PRNGKey(7)))

    # 5. AEES (multimodal) + RM-HMC ((mu, sigma) with Fisher metric)
    # 24000 kept draws: the T=1-chain mode-occupancy statistic needs the
    # long window to pass the R-hat <= 1.01 gate (12000 sat at 1.0113).
    # Ladder: 4-rung geometric (benchmarks/aees_ladder_sweep.py scans
    # K=3..6; adapt_ladder=True reconstructs the same family). 32
    # replicas.
    aees_settings = mcmc_tpu.AEESSettings(
        n_initial_draws=500 // scale, n_burnin_draws=500 // scale,
        n_keep_draws=24000 // scale, n_rings=11, ee_prob_par=0.05,
        temper_vec=jnp.array([60.0, 15.3, 3.9]), cov_mat=0.35 * jnp.eye(2))
    lk_hard = models.gaussian_mixture_model(mu, jnp.array([0.1, 0.1]),
                                            jnp.array([0.5, 0.5]))
    record("aees_mixture", lambda: mcmc_tpu.aees(
        mu[0], lk_hard, aees_settings, key=jax.random.PRNGKey(8), n_runs=C(32),
        history_capacity=512))
    # 5b. parallel tempering (beyond-reference) on the same hard mixture
    # (256 chains x 3000 draws — vmapped ladders are near-free on the chip,
    # and the mode-occupancy statistic that drives split R-hat on a
    # 0.1-variance mixture needs the large sample)
    record("pt_mixture", lambda: mcmc_tpu.pt(
        mu[0], lk_hard,
        mcmc_tpu.PTSettings(n_burnin_draws=1000 // scale,
                            n_keep_draws=3000 // scale,
                            n_temps=6, max_temp=60.0, adapt_temps=True,
                            inner="hmc", step_size=0.12, n_leap_steps=5),
        n_chains=C(256), key=jax.random.PRNGKey(11)))
    # 5c. tempered SMC (beyond-reference) on the same hard mixture. SMC
    # returns one weighted-then-resampled population, not a chain trace, so
    # chain diagnostics don't apply; its quality metrics are the log-evidence
    # error (the mixture density is normalized, so true log Z = 0) and the
    # recovered mode-mass split (true 0.5/0.5).
    def run_smc():
        t0 = time.perf_counter()
        out = mcmc_tpu.smc(
            jnp.zeros(2), lk_mix,
            mcmc_tpu.SMCSettings(n_particles=16384 // scale, n_mcmc_steps=5,
                                 init_scale=4.0),
            key=jax.random.PRNGKey(12))
        jax.block_until_ready(out.draws)
        el = time.perf_counter() - t0
        cloud = np.asarray(out.draws)
        mass_hi = float((cloud[:, 0] > 0).mean())
        log_z_err = abs(float(out.diagnostics["log_z"]))
        mass_err = abs(mass_hi - 0.5)
        # explicit recorded pass thresholds (this config emits no R-hat, so
        # without its own gate it would escape all_converged): |log Z|
        # within 0.05 of the true 0 and mode mass
        # within 0.05 of the true 0.5/0.5 split
        row = {
            "config": "smc_mixture",
            "seconds": round(el, 2),
            "particles_per_sec": round(cloud.shape[0] / el, 1),
            "n_stages": int(out.diagnostics["n_stages"]),
            "abs_log_z_error": round(log_z_err, 4),
            "abs_log_z_gate": 0.05,
            "mode_mass_error": round(mass_err, 4),
            "mode_mass_gate": 0.05,
            "passed": bool(log_z_err <= 0.05 and mass_err <= 0.05),
        }
        results.append(row)
        print(json.dumps(row), flush=True)
    run_smc()

    # 5d. affine-invariant ensemble (beyond-reference) on a rho=0.95
    # correlated Gaussian — the target class its affine invariance makes
    # free; no preconditioner or scale anywhere
    rho = 0.95
    cov_c = jnp.array([[1.0, rho], [rho, 1.0]])
    prec_c = jnp.linalg.inv(cov_c)
    record("stretch_correlated", lambda: mcmc_tpu.stretch(
        jnp.zeros(2), lambda v: -0.5 * v @ prec_c @ v,
        mcmc_tpu.StretchSettings(n_walkers=C(256),
                                 n_burnin_draws=2000 // scale,
                                 n_keep_draws=6000 // scale),
        key=jax.random.PRNGKey(13)))

    # 5e. elliptical slice (beyond-reference) on a 64-d latent GP — the
    # correlated-Gaussian-prior class nothing in the reference can touch;
    # zero tuning parameters
    xs_gp = jnp.linspace(0.0, 4.0, 64)
    K_gp = models.rbf_kernel(xs_gp, length_scale=0.5)
    y_gp = jnp.sin(2.0 * xs_gp)
    # (a strong likelihood makes the ellipse take small steps — the known
    # cost profile of ESS under data-dominated posteriors — so this config
    # pairs moderate noise 0.25 with a longer window for the R-hat gate)
    record("elliptical_latent_gp_64d", lambda: mcmc_tpu.elliptical_slice(
        jnp.zeros(64), lambda f: -0.5 * jnp.sum((y_gp - f) ** 2) / 0.25,
        mcmc_tpu.EllipticalSettings(n_burnin_draws=3000 // scale,
                                    n_keep_draws=12000 // scale),
        prior_cov=K_gp, n_chains=C(64), key=jax.random.PRNGKey(14)))

    # 5f. slice-within-Gibbs (beyond-reference) on the 2-d mean/scale
    # posterior — self-tuning brackets, no acceptance target
    record("slice_gaussian_2d", lambda: mcmc_tpu.slice_sampler(
        jnp.array([2.0, 2.0]), lk_ms,
        mcmc_tpu.SliceSettings(n_burnin_draws=1000 // scale,
                               n_keep_draws=4000 // scale),
        n_chains=C(256), key=jax.random.PRNGKey(15)))

    # 5g. DE-MC(Z) (beyond-reference) — 6 walkers on a 10-d correlated
    # Gaussian: the small-population regime plain DE cannot reach. 64
    # independent replicas (own archives): cross-run R-hat is honest
    # (within a run walkers couple through the shared archive) and the
    # 384-chain evidence lets the run be half as long
    rho_z = 0.8
    cov_z = rho_z * jnp.ones((10, 10)) + (1 - rho_z) * jnp.eye(10)
    P_z = jnp.linalg.inv(cov_z)
    record("demcz_correlated_10d", lambda: mcmc_tpu.demcz(
        jnp.zeros(10), lambda x: -0.5 * x @ P_z @ x,
        mcmc_tpu.DEMCZSettings(n_pop=6, n_burnin_draws=2500 // scale,
                               n_keep_draws=4500 // scale),
        n_runs=C(64), key=jax.random.PRNGKey(16)))

    # rmhmc_fisher: 1024 chains and n_fp_steps=3 (the generalized-
    # leapfrog fixed point converges by 2 iterations on this target:
    # nfp 1/2/3/5 all measure acc 0.998-0.999, min bulk ESS 6551-6594,
    # identical posterior means — the reference's hard-coded 5
    # (mcmc_structs.hpp:113) buys nothing here)
    record("rmhmc_fisher", lambda: mcmc_tpu.rmhmc(
        jnp.array([2.5, 2.5]), lk_ms, models.normal_fisher_metric(1000),
        mcmc_tpu.RMHMCSettings(n_burnin_draws=1500 // scale,
                               n_keep_draws=4000 // scale,
                               step_size=0.15, n_leap_steps=3,
                               n_fp_steps=3),
        n_chains=C(1024), key=jax.random.PRNGKey(9)))

    # block-Gibbs: the semi-conjugate hierarchical
    # model of examples/gibbs_semi_conjugate.py — 16 exact-conjugate group
    # effects + an adapted-HMC (mu, log tau) hyperblock per sweep.
    J_g = 16
    _kg1, _kg2 = jax.random.split(jax.random.PRNGKey(42))
    sigma_g = jnp.full((J_g,), 4.0)
    theta_true_g = 4.0 + 6.0 * jax.random.normal(_kg1, (J_g,))
    y_g = theta_true_g + sigma_g * jax.random.normal(_kg2, (J_g,))

    def lk_gibbs(v):
        theta, mu_h, log_tau = v[:J_g], v[J_g], v[J_g + 1]
        tau = jnp.exp(log_tau)
        lp = -0.5 * jnp.sum((y_g - theta) ** 2 / sigma_g ** 2)
        lp += -0.5 * jnp.sum((theta - mu_h) ** 2) / tau ** 2 - J_g * log_tau
        lp += -0.5 * mu_h ** 2 / 25.0
        lp += -0.5 * tau ** 2 / 64.0 + log_tau
        return lp

    def cond_theta_g(k, full):
        mu_h, tau = full[J_g], jnp.exp(full[J_g + 1])
        prec = 1.0 / sigma_g ** 2 + 1.0 / tau ** 2
        mean = (y_g / sigma_g ** 2 + mu_h / tau ** 2) / prec
        return mean + jax.random.normal(k, (J_g,), full.dtype) / jnp.sqrt(prec)

    record("gibbs_hierarchical", lambda: mcmc_tpu.gibbs(
        jnp.zeros(J_g + 2), lk_gibbs,
        mcmc_tpu.GibbsSettings(n_burnin_draws=2000 // scale,
                               n_keep_draws=4000 // scale),
        blocks=[(list(range(J_g)), cond_theta_g),
                (list(range(J_g, J_g + 2)), "hmc",
                 {"step_size": 0.1, "n_leap_steps": 8})],
        n_chains=C(256), key=jax.random.PRNGKey(26)))

    rhats = [r["max_split_rhat"] for r in results if "max_split_rhat" in r]
    rank_rhats = [r["max_rank_rhat"] for r in results if "max_rank_rhat" in r]
    # NaN sorts as +inf so a diverged/frozen config surfaces as
    # worst_*_rhat: NaN instead of being silently dropped by max()
    nan_max = lambda vs: max(vs, key=lambda v: float("inf") if v != v else v)
    # every config is gated: chain configs by rank-normalized R-hat <= 1.01
    # (Vehtari et al. 2021), non-chain configs (SMC) by their own explicit
    # recorded thresholds — "all_converged" means ALL rows passed
    explicit_gates = [r["passed"] for r in results if "passed" in r]
    ungated = [r["config"] for r in results
               if "max_rank_rhat" not in r and "passed" not in r]
    assert not ungated, f"configs with no quality gate: {ungated}"
    summary = {"suite": "baseline_configs", "n_configs": len(results),
               "worst_split_rhat": nan_max(rhats),
               "worst_rank_rhat": nan_max(rank_rhats),
               "all_converged": bool(nan_max(rank_rhats) <= 1.01
                                     and all(explicit_gates)),
               "platform": dev.platform, "device_kind": dev.device_kind}
    print(json.dumps(summary))
    if out_path is not None:
        pathlib.Path(out_path).write_text(
            json.dumps({"summary": summary, "configs": results}, indent=1))


if __name__ == "__main__":
    quick = "--quick" in sys.argv
    out_path = None
    for i, a in enumerate(sys.argv):
        if a == "--out" and i + 1 < len(sys.argv):
            out_path = sys.argv[i + 1]
    platform = "gpu"
    if "--cpu" in sys.argv:
        import os
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
        platform = "cpu"
    run_all(quick=quick, out_path=out_path, platform=platform)
