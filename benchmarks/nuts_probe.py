#!/usr/bin/env python
"""NUTS protocol probe (round 3): measure min-ESS/s for candidate
straggler-mitigation / quality variants of the bench NUTS protocol on the
flagship 100-d logistic regression, plus the 4096-chain draw-buffer ceiling.

Variants:
  base        round-2 protocol (pooled DA @0.8, diag mass, depth budget)
  multinomial Boltzmann leaf weights (Betancourt 2017) instead of slice
  ta65        target_accept 0.65 (bigger steps, shallower trees)
  q90         depth_quantile 0.90 (more aggressive learned cap)
  mn_ta65     multinomial + target 0.65

Each prints one JSON line; run on the GPU, alone on the card. 4096-chain
mode (--chains 4096) computes diagnostics ON DEVICE so no draw transfer
reaches the host.
"""

import json
import sys
import time
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
from jax import lax

import mcmc_tpu
from mcmc_tpu import models, diagnostics
from mcmc_tpu.samplers import common
from mcmc_tpu.samplers.nuts import build_nuts_kernel

DIM, N_DATA = 100, 1000
WARMUP, KEEP = 500, 1000


def run_variant(name, log_kernel, n_chains, target=0.8, sample_method="slice",
                depth_quantile=0.98, device_diag=False, static_recap=False):
    s = mcmc_tpu.NUTSSettings(n_burnin_draws=WARMUP, n_keep_draws=KEEP,
                              n_adapt_draws=WARMUP, target_accept_rate=target)
    precond = common.make_spd(None, DIM, jnp.float32)
    init, step = build_nuts_kernel(log_kernel, jax.grad(log_kernel), precond,
                                   s, WARMUP, pooled_adaptation=True,
                                   adapt_mass_matrix=True, adapt_depth=True,
                                   depth_quantile=depth_quantile,
                                   sample_method=sample_method)
    bstep = jax.vmap(step, axis_name=common.CHAIN_AXIS_NAME)

    keys = jax.random.split(jax.random.PRNGKey(11), n_chains)
    pos0 = 0.05 * jax.random.normal(jax.random.PRNGKey(12), (n_chains, DIM))
    state0 = jax.vmap(init, axis_name=common.CHAIN_AXIS_NAME)(keys, pos0)

    def make_scan(bstep_fn, collect, n):
        def run(state, ks):
            def body(c, _):
                st, k = c
                pairs = jax.vmap(lambda kk: jax.random.split(kk, 2))(k)
                st, info = bstep_fn(pairs[:, 1], st)
                out = (st.position, info["tree_depth"], info["diverged"]) \
                    if collect else None
                return (st, pairs[:, 0]), out
            (st, k), outs = lax.scan(body, (state, ks), None, length=n)
            return st, k, outs
        return jax.jit(run)

    def scan_phase(n, collect):
        return make_scan(bstep, collect, n)

    warm = scan_phase(WARMUP, collect=False)

    ks = jax.random.split(jax.random.PRNGKey(13), n_chains)
    t0 = time.perf_counter()
    stw, ks, _ = warm(state0, ks)
    jax.block_until_ready(stw)
    t_warm = time.perf_counter() - t0

    if static_recap:
        # rebuild the sampling kernel with the learned depth budget as the
        # STATIC tree size: checkpoint buffers shrink from (11, d) to
        # (cap+1, d) and the per-leaf progressive U-turn scan runs cap
        # levels instead of 10 — the bookkeeping (not the gradients) is
        # what each draw pays for at these shapes
        cap = int(jnp.asarray(stw.depth_cap)[0])
        s2 = mcmc_tpu.NUTSSettings(
            n_burnin_draws=WARMUP, n_keep_draws=KEEP, n_adapt_draws=WARMUP,
            target_accept_rate=target, max_tree_depth=cap)
        _i2, step2 = build_nuts_kernel(
            log_kernel, jax.grad(log_kernel), precond, s2, WARMUP,
            pooled_adaptation=True, adapt_mass_matrix=True,
            sample_method=sample_method)
        stw = stw._replace(
            depth_hist=jnp.zeros((n_chains, cap + 1), jnp.int32),
            depth_cap=jnp.full((n_chains,), cap, jnp.int32))
        bstep = jax.vmap(step2, axis_name=common.CHAIN_AXIS_NAME)

    samp = make_scan(bstep, True, KEEP)

    _st, _ks, outs = samp(stw, ks)
    jax.block_until_ready(outs[0])
    t0 = time.perf_counter()
    _st, _ks, (draws, depth, div) = samp(stw, ks)
    jax.block_until_ready(draws)
    t_samp = time.perf_counter() - t0

    if device_diag:
        # large-chain mode: draws stay in device memory; diagnostics
        # computed on device (chunked-FFT ESS bounds the workspace), only
        # the reduced scalars reach the host. Rank-normalized R-hat (a full pooled
        # argsort) is skipped at this size — split R-hat gates.
        ess_min = float(jax.jit(
            lambda d: diagnostics.ess(d, chain_chunk=512).min())(draws))
        rhat = float(jax.jit(lambda d: diagnostics.split_rhat(d).max())(draws))
        rank_rhat = float("nan")
        depth_mean = float(depth.mean())
        ndiv = int(div.sum())
    else:
        import numpy as np
        draws = np.asarray(draws)
        ess_min = float(diagnostics.ess(draws).min())
        rhat = float(diagnostics.split_rhat(draws).max())
        rank_rhat = float(diagnostics.rank_normalized_rhat(draws).max())
        depth_mean = float(np.asarray(depth).mean())
        ndiv = int(np.asarray(div).sum())

    row = {"variant": name, "chains": n_chains,
           "min_ess_per_sec": round(ess_min / t_samp, 1),
           "draws_per_sec": round(KEEP * n_chains / t_samp, 1),
           "max_split_rhat": round(rhat, 4),
           "max_rank_rhat": round(rank_rhat, 4),
           "mean_tree_depth": round(depth_mean, 2),
           "n_divergent": ndiv,
           "depth_cap": int(jnp.asarray(stw.depth_cap)[0]),
           "adapted_step_size": round(float(stw.epsilon_bar[0]), 4),
           "warmup_s": round(t_warm, 2), "sample_s": round(t_samp, 3)}
    print(json.dumps(row), flush=True)
    return row


def main():
    from mcmc_tpu.device import enable_compile_cache
    enable_compile_cache()
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0),
                                                   N_DATA, DIM)
    lk = models.logistic_regression_model(X, y)
    chains = 1024
    variants = sys.argv[1:] or ["base", "multinomial", "ta65", "q90",
                                "mn_ta65"]
    for v in variants:
        if v.startswith("chains"):
            n = int(v[len("chains"):])
            run_variant(f"base@{n}", lk, n, device_diag=n >= 2048)
        elif v == "base":
            run_variant("base", lk, chains)
        elif v == "multinomial":
            run_variant("multinomial", lk, chains,
                        sample_method="multinomial")
        elif v.startswith("ta") or v.startswith("mn_ta"):
            # [mn_]taNN[-qMM][-static][@CHAINS]: target acceptance sweep
            # with optional multinomial tree sampling, depth quantile, and
            # static post-warmup tree recap
            mn = v.startswith("mn_ta")
            spec = v[5:] if mn else v[2:]
            n = chains
            q = 0.98
            recap = False
            if "@" in spec:
                spec, cn = spec.split("@")
                n = int(cn)
            if "-static" in spec:
                spec = spec.replace("-static", "")
                recap = True
            if "-q" in spec:
                spec, qs = spec.split("-q")
                q = int(qs) / 100.0
            run_variant(v, lk, n, target=int(spec) / 100.0,
                        depth_quantile=q, device_diag=n >= 2048,
                        static_recap=recap,
                        sample_method="multinomial" if mn else "slice")
        elif v == "q90":
            run_variant("q90", lk, chains, depth_quantile=0.90)
        else:
            raise SystemExit(f"unknown variant {v}")


if __name__ == "__main__":
    main()
