#!/usr/bin/env python
"""Protocol probe for the microcanonical samplers on the BASELINE flagship
(100-d Bayesian logistic regression): min-ESS/s for MCLMC (unadjusted) and
MAMS (exact) across chain counts and thinning, with on-device diagnostics
(only reduced scalars reach the host).

Usage: python benchmarks/mclmc_probe.py [variant ...]
Variants: mclmc-1024 mclmc-4096 mclmc-4096-thin4 mams-1024 mams-4096 ...
Default: all. Results printed one JSON line per variant; run on the GPU.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
from jax import lax

import mcmc_tpu
from mcmc_tpu import diagnostics, models
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers.mclmc import build_mclmc_kernel, build_mams_kernel

DIM = 100
N_DATA = 1000
WARMUP = 500
KEEP = 1000


def run_variant(name, lk, kind, n_chains, thin=1, keep=KEEP,
                desired_energy_var=5e-4, integrator="velocity_verlet"):
    if kind == "mclmc":
        s = mcmc_tpu.MCLMCSettings(n_burnin_draws=WARMUP, n_keep_draws=keep,
                                   desired_energy_var=desired_energy_var,
                                   integrator=integrator)
        init, step = build_mclmc_kernel(lk, s, WARMUP, adapt_mass=True)
    else:
        s = mcmc_tpu.MAMSSettings(n_burnin_draws=WARMUP, n_keep_draws=keep,
                                  integrator=integrator)
        init, step = build_mams_kernel(lk, s, WARMUP, adapt_mass=True)
    step = common.thin_step(step, thin)
    bstep = jax.vmap(step, axis_name=common.CHAIN_AXIS_NAME)

    pos0 = 0.05 * jax.random.normal(jax.random.PRNGKey(12), (n_chains, DIM))
    ik = jax.random.split(jax.random.PRNGKey(7), n_chains)
    state0 = jax.vmap(lambda k, x: init(k, x, float(DIM) ** 0.5,
                                        0.1 * float(DIM) ** 0.5),
                      axis_name=common.CHAIN_AXIS_NAME)(ik, pos0)

    def scan_phase(n, collect):
        def run(state, ks):
            def body(c, _):
                st, k = c
                pairs = jax.vmap(lambda kk: jax.random.split(kk, 2))(k)
                st, info = bstep(pairs[:, 1], st)
                out = st.position if collect else None
                return (st, pairs[:, 0]), out
            (st, k), outs = lax.scan(body, (state, ks), None, length=n)
            return st, k, outs
        return jax.jit(run)

    warm = scan_phase(WARMUP, collect=False)
    samp = scan_phase(keep, collect=True)
    ks = jax.random.split(jax.random.PRNGKey(13), n_chains)
    t0 = time.perf_counter()
    stw, ks, _ = warm(state0, ks)
    jax.block_until_ready(stw)
    t_warm = time.perf_counter() - t0

    _st, _ks, outs = samp(stw, ks)      # compile off the clock
    jax.block_until_ready(outs)
    t0 = time.perf_counter()
    _st, _ks, draws = samp(stw, ks)
    jax.block_until_ready(draws)
    t_samp = time.perf_counter() - t0

    @jax.jit
    def diag(d):
        return (diagnostics.ess(d, chain_chunk=256).min(),
                diagnostics.split_rhat(d).max(),
                d.mean((0, 1)), d.std((0, 1)))

    ess_min, rhat, mean, std = diag(draws)
    ess_min, rhat = float(ess_min), float(rhat)
    out = {
        "variant": name, "chains": n_chains, "thin": thin, "keep": keep,
        "min_ess_per_sec": round(ess_min / t_samp, 1),
        "min_ess": round(ess_min, 1),
        "draws_per_sec": round(keep * n_chains / t_samp, 1),
        "chain_steps_per_sec": round(keep * thin * n_chains / t_samp, 1),
        "max_split_rhat": round(rhat, 4),
        "converged": bool(rhat <= 1.01),
        "warmup_seconds": round(t_warm, 2),
        "sample_seconds": round(t_samp, 3),
        "adapted_step_size": round(float(jnp.exp(stw.da.log_eps_bar[0])), 4),
        "adapted_L": round(float(jnp.exp(stw.log_L[0])), 3),
    }
    return out, (mean, std)


def main():
    from mcmc_tpu.device import enable_compile_cache
    enable_compile_cache()
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0),
                                                   N_DATA, DIM)
    lk = models.logistic_regression_model(X, y)

    variants = {
        "mams-1024": dict(kind="mams", n_chains=1024),
        "mams-4096": dict(kind="mams", n_chains=4096),
        "mclmc-1024": dict(kind="mclmc", n_chains=1024),
        "mclmc-1024-thin4": dict(kind="mclmc", n_chains=1024, thin=4),
        "mclmc-4096": dict(kind="mclmc", n_chains=4096),
        "mclmc-4096-thin4": dict(kind="mclmc", n_chains=4096, thin=4),
        "mclmc-4096-thin8": dict(kind="mclmc", n_chains=4096, thin=8),
        "mclmc-16384-thin4": dict(kind="mclmc", n_chains=16384, thin=4),
        "mclmc-16384-thin8": dict(kind="mclmc", n_chains=16384, thin=8),
        "mams-4096-thin2": dict(kind="mams", n_chains=4096, thin=2),
        "mclmc-4096-mn-thin2": dict(kind="mclmc", n_chains=4096, thin=2,
                                    integrator="mclachlan"),
        "mclmc-4096-mn-thin4": dict(kind="mclmc", n_chains=4096, thin=4,
                                    integrator="mclachlan"),
        "mams-4096-mn": dict(kind="mams", n_chains=4096,
                             integrator="mclachlan"),
        "mclmc-8192-mn-thin2": dict(kind="mclmc", n_chains=8192, thin=2,
                                    integrator="mclachlan"),
        "mams-8192-mn": dict(kind="mams", n_chains=8192,
                             integrator="mclachlan"),
        "mclmc-4096-mn-thin2-dev1e3": dict(
            kind="mclmc", n_chains=4096, thin=2, integrator="mclachlan",
            desired_energy_var=1e-3),
        "mclmc-4096-mn-thin1": dict(kind="mclmc", n_chains=4096, thin=1,
                                    integrator="mclachlan"),
    }
    names = sys.argv[1:] or list(variants)
    moments = {}
    for name in names:
        out, (mean, std) = run_variant(name, lk, **variants[name])
        moments[name] = (mean, std)
        print(json.dumps(out), flush=True)
    # moment parity: unadjusted vs the exact sampler (bias check)
    ref = next((m for n, m in moments.items() if n.startswith("mams")), None)
    if ref is not None:
        for name, (mean, std) in moments.items():
            if name.startswith("mams"):
                continue
            dmean = float(jnp.abs(mean - ref[0]).max())
            dstd = float(jnp.abs(std / ref[1] - 1.0).max())
            print(json.dumps({"bias_check": name,
                              "max_abs_mean_diff": round(dmean, 4),
                              "max_rel_std_diff": round(dstd, 4)}),
                  flush=True)


if __name__ == "__main__":
    main()
