#!/usr/bin/env python
"""GHMC protocol probe on the BASELINE flagship (100-d Bayesian logistic
regression): min-ESS/s across momentum persistence, chain count, and
thinning, with on-device diagnostics (only reduced scalars reach the
host).

The alpha=0 variants are the full-refresh control — the same kernel
degenerates to 1-leapfrog HMC there, so the persistence benefit is
isolated within one compiled program family.

Usage: python benchmarks/ghmc_probe.py [variant ...]   (run on the GPU)
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
from jax import lax

import mcmc_tpu  # noqa: F401  (settings re-exports)
from mcmc_tpu import diagnostics, models
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers.ghmc import build_ghmc_kernel

DIM = 100
N_DATA = 1000
WARMUP = 1000
KEEP = 1000


def run_variant(name, lk, n_chains, alpha, thin=1, keep=KEEP, jitter=0.2,
                step_size=0.05, target=0.95, n_leap=1):
    precond = common.make_spd(None, DIM, jnp.float32)
    init, step = build_ghmc_kernel(
        lk, jax.grad(lk), precond, step_size, alpha, n_leap, jitter,
        {"n_burnin": WARMUP, "target": target})
    step = common.thin_step(step, thin)
    bstep = jax.vmap(step, axis_name=common.CHAIN_AXIS_NAME)

    pos0 = 0.05 * jax.random.normal(jax.random.PRNGKey(12), (n_chains, DIM))
    state0 = jax.vmap(init)(pos0)

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
                diagnostics.split_rhat(d).max())

    ess_min, rhat = map(float, diag(draws))
    out = {
        "variant": name, "chains": n_chains, "alpha": alpha, "thin": thin,
        "keep": keep,
        "min_ess_per_sec": round(ess_min / t_samp, 1),
        "min_ess": round(ess_min, 1),
        "draws_per_sec": round(keep * n_chains / t_samp, 1),
        "grad_evals_per_sec": round(keep * thin * n_chains
                                    * n_leap / t_samp, 1),
        "max_split_rhat": round(rhat, 4),
        "converged": bool(rhat <= 1.01),
        "warmup_seconds": round(t_warm, 2),
        "sample_seconds": round(t_samp, 3),
        "adapted_step_size": round(
            float(jnp.exp(stw.da.log_eps_bar[0])), 5),
    }
    return out


def main():
    from mcmc_tpu.device import enable_compile_cache
    enable_compile_cache()
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0),
                                                   N_DATA, DIM)
    lk = models.logistic_regression_model(X, y)

    variants = {
        "a0-4096-thin4": dict(n_chains=4096, alpha=0.0, thin=4),
        "a90-4096-thin4": dict(n_chains=4096, alpha=0.9, thin=4),
        "a98-4096-thin4": dict(n_chains=4096, alpha=0.98, thin=4),
        "a98-4096-thin8": dict(n_chains=4096, alpha=0.98, thin=8),
        "a98-1024-thin8": dict(n_chains=1024, alpha=0.98, thin=8),
        "a995-4096-thin8": dict(n_chains=4096, alpha=0.995, thin=8),
        # trajectory-length sweep (r5): does L > 1 beat the one-gradient
        # draw at matched thin*L gradient budget?
        "a98-4096-L2-thin4": dict(n_chains=4096, alpha=0.98, thin=4,
                                  n_leap=2),
        "a95-4096-L4-thin2": dict(n_chains=4096, alpha=0.95, thin=2,
                                  n_leap=4),
        "a90-4096-L8-thin1": dict(n_chains=4096, alpha=0.9, thin=1,
                                  n_leap=8),
        "a98-4096-L2-thin2": dict(n_chains=4096, alpha=0.98, thin=2,
                                  n_leap=2),
        "a95-4096-L2-thin4": dict(n_chains=4096, alpha=0.95, thin=4,
                                  n_leap=2),
        "a98-4096-L3-thin3": dict(n_chains=4096, alpha=0.98, thin=3,
                                  n_leap=3),
        "a99-4096-L2-thin4": dict(n_chains=4096, alpha=0.99, thin=4,
                                  n_leap=2),
        "a99-4096-L3-thin3": dict(n_chains=4096, alpha=0.99, thin=3,
                                  n_leap=3),
        "a98-4096-L3-thin2": dict(n_chains=4096, alpha=0.98, thin=2,
                                  n_leap=3),
        "a98-4096-L4-thin2": dict(n_chains=4096, alpha=0.98, thin=2,
                                  n_leap=4),
        "a98-4096-L3-thin4": dict(n_chains=4096, alpha=0.98, thin=4,
                                  n_leap=3),
    }
    names = sys.argv[1:] or list(variants)
    for name in names:
        print(json.dumps(run_variant(name, lk, **variants[name])),
              flush=True)


if __name__ == "__main__":
    main()
