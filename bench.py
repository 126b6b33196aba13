#!/usr/bin/env python
"""Benchmark: leapfrog steps/sec/chip + converged NUTS ESS/sec, 100-d
Bayesian logistic regression (the BASELINE.md primary workload).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

vs_baseline compares against a single-thread C++ sequential HMC of the same
model, structured like the reference's hmc_impl and compiled with the
reference's own -O3 -march=native flags (benchmarks/baseline_hmc.cpp) — the
reference library itself publishes no numbers and its Armadillo/Eigen
dependencies are not installable here (BASELINE.md). The C++ number is
measured once on the host that runs the benchmark and cached in
benchmarks/baseline_cpp.json (not committed).

Two measurements:

1. **Throughput** (the headline metric): 16384 chains through the fused
   GLM HMC step (one Pallas kernel on the Triton route per block of chains;
   (chains, d) x (d, n) products in bfloat16 with f32 accumulation — see
   mcmc_tpu/ops/fused_logreg.py for its precision contract).

2. **Statistical quality** (BASELINE "ESS/sec ... R-hat parity"): NUTS with
   full warmup adaptation — pooled dual averaging at 0.8 target accept,
   windowed diagonal mass-matrix adaptation, and a learned tree-depth
   budget — on the same posterior; min/bulk/tail ESS per second over the
   post-warmup phase, gated on max split R-hat <= 1.01 ("converged": the
   quality numbers are only claimed when the gate passes).

It needs a GPU and stops when JAX finds none.
"""

import json
import pathlib
import subprocess
import time

ROOT = pathlib.Path(__file__).resolve().parent
BASELINE_CACHE = ROOT / "benchmarks" / "baseline_cpp.json"

N_CHAINS = 16384
DIM = 100
N_DATA = 1000
N_LEAP = 4
STEP_SIZE = 0.01

# 1024 chains for the quality line; the 4096-chain line below exercises the
# large-batch path with on-device (chunked-FFT) diagnostics: no draw
# transfer, bounded device memory. The chain counts and the target accept
# rate below have not been re-measured on the GPU.
NUTS_CHAINS = 1024
NUTS_BIG_CHAINS = 4096
NUTS_WARMUP = 500
NUTS_KEEP = 1000
# benchmarks/nuts_probe.py sweeps the target accept rate; 0.65 is its
# choice, with a stability margin over 0.55
NUTS_TARGET_ACCEPT = 0.65


def cpp_baseline_steps_per_sec():
    """Build + run (once) the C++ sequential-HMC stand-in for the reference."""
    if BASELINE_CACHE.exists():
        return json.loads(BASELINE_CACHE.read_text())["leapfrog_steps_per_sec"]
    exe = ROOT / "benchmarks" / "baseline_hmc"
    src = ROOT / "benchmarks" / "baseline_hmc.cpp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-ffp-contract=fast",
             str(src), "-o", str(exe)],
            check=True, capture_output=True, timeout=120,
        )
        out = subprocess.run([str(exe), "3.0"], check=True, capture_output=True,
                             timeout=60, text=True)
        val = float(out.stdout.strip())
        BASELINE_CACHE.write_text(json.dumps({"leapfrog_steps_per_sec": val}))
        return val
    except Exception:
        return None


def measure_throughput(X, y):
    import jax
    from jax import lax
    from mcmc_tpu.ops.fused_logreg import make_fused_hmc_step

    # tiles: the kernel's defaults (benchmarks/fused_glm_sweep.py); 400
    # transitions per jitted call keep the per-call dispatch off the rate
    step = make_fused_hmc_step(X, y, step_size=STEP_SIZE, n_leap=N_LEAP)
    positions = 0.05 * jax.random.normal(jax.random.PRNGKey(1), (N_CHAINS, DIM))
    state = step.init(positions)

    STEPS_PER_CALL = 400
    N_CALLS = 40

    @jax.jit
    def run_steps(key, state):
        def body(carry, _):
            st, k = carry
            k, sub = jax.random.split(k)
            st, info = step(sub, st)
            return (st, k), info["accepted"].mean()
        (state, key), acc = lax.scan(body, (state, key), None,
                                     length=STEPS_PER_CALL)
        return key, state, acc.mean()

    key = jax.random.PRNGKey(2)
    key, state, acc = run_steps(key, state)          # warmup / compile
    jax.block_until_ready(state)

    # Async dispatch: each call consumes the previous call's state, so the
    # device pipelines back-to-back; one block at the end keeps the host
    # round trip off the measurement (per-run overhead, not per-step
    # cost).
    t0 = time.perf_counter()
    for _ in range(N_CALLS):
        key, state, acc = run_steps(key, state)
    jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0

    total = N_CALLS * STEPS_PER_CALL * N_LEAP * N_CHAINS
    return total / elapsed, float(acc)


def measure_nuts_quality(log_kernel, n_chains=NUTS_CHAINS, prefix="nuts",
                         device_diag=False):
    """Adapted-NUTS ESS/sec with a convergence gate: pooled dual averaging + windowed diag mass + depth budget over
    NUTS_WARMUP draws, then a timed sampling phase of NUTS_KEEP draws.

    ``device_diag=True`` (the 4096-chain line) keeps the draw history in
    device memory and computes diagnostics on device — ESS via
    the chunked-FFT estimator (``diagnostics.ess(chain_chunk=...)``) whose
    workspace stays bounded; only reduced scalars cross the host link.
    Rank R-hat (a full pooled argsort) is skipped at that size; split
    R-hat gates."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    import mcmc_tpu
    from mcmc_tpu import diagnostics
    from mcmc_tpu.samplers import common
    from mcmc_tpu.samplers.nuts import build_nuts_kernel

    s = mcmc_tpu.NUTSSettings(n_burnin_draws=NUTS_WARMUP, n_keep_draws=NUTS_KEEP,
                              n_adapt_draws=NUTS_WARMUP,
                              target_accept_rate=NUTS_TARGET_ACCEPT)
    precond = common.make_spd(None, DIM, jnp.float32)
    init, step = build_nuts_kernel(log_kernel, jax.grad(log_kernel), precond,
                                   s, NUTS_WARMUP, pooled_adaptation=True,
                                   adapt_mass_matrix=True, adapt_depth=True)
    bstep = jax.vmap(step, axis_name=common.CHAIN_AXIS_NAME)

    keys = jax.random.split(jax.random.PRNGKey(11), n_chains)
    pos0 = 0.05 * jax.random.normal(jax.random.PRNGKey(12), (n_chains, DIM))
    state0 = jax.vmap(init, axis_name=common.CHAIN_AXIS_NAME)(keys, pos0)

    def make_scan(bstep_fn, n, collect):
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

    warm = make_scan(bstep, NUTS_WARMUP, collect=False)

    ks = jax.random.split(jax.random.PRNGKey(13), n_chains)
    t0 = time.perf_counter()
    stw, ks, _ = warm(state0, ks)
    jax.block_until_ready(stw)
    t_warm = time.perf_counter() - t0

    # static tree recap (mcmc_tpu.nuts(static_sampling_depth=True)): the
    # sampling kernel is rebuilt with the learned depth budget as the
    # static tree size — checkpoint buffers and the per-leaf U-turn scan
    # shrink from max_depth=10 to the cap
    cap = int(jnp.max(jnp.asarray(stw.depth_cap)))
    s2 = mcmc_tpu.NUTSSettings(
        n_burnin_draws=NUTS_WARMUP, n_keep_draws=NUTS_KEEP,
        n_adapt_draws=NUTS_WARMUP, target_accept_rate=NUTS_TARGET_ACCEPT,
        max_tree_depth=cap)
    _i2, step2 = build_nuts_kernel(log_kernel, jax.grad(log_kernel), precond,
                                   s2, NUTS_WARMUP, pooled_adaptation=True,
                                   adapt_mass_matrix=True)
    stw = stw._replace(
        depth_hist=jnp.zeros((n_chains, cap + 1), jnp.int32),
        depth_cap=jnp.full((n_chains,), cap, jnp.int32))
    bstep = jax.vmap(step2, axis_name=common.CHAIN_AXIS_NAME)
    samp = make_scan(bstep, NUTS_KEEP, collect=True)

    # compile the sampling phase off the clock, then measure
    _st, _ks, outs = samp(stw, ks)
    jax.block_until_ready(outs[0])
    t0 = time.perf_counter()
    _st, _ks, (draws, depth, div) = samp(stw, ks)
    jax.block_until_ready(draws)
    t_samp = time.perf_counter() - t0

    p = prefix
    if device_diag:
        ess_min = float(jax.jit(
            lambda d: diagnostics.ess(d, chain_chunk=512).min())(draws))
        rhat = float(jax.jit(lambda d: diagnostics.split_rhat(d).max())(draws))
        extra = {}
    else:
        import numpy as np
        draws = np.asarray(draws)
        ess_min = float(diagnostics.ess(draws).min())
        rhat = float(diagnostics.split_rhat(draws).max())
        extra = {
            f"{p}_bulk_ess_per_sec": round(
                float(diagnostics.bulk_ess(draws).min()) / t_samp, 1),
            f"{p}_tail_ess_per_sec": round(
                float(diagnostics.tail_ess(draws).min()) / t_samp, 1),
            f"{p}_max_rank_rhat": round(
                float(diagnostics.rank_normalized_rhat(draws).max()), 4),
        }
    return {
        f"{p}_min_ess_per_sec": round(ess_min / t_samp, 1),
        f"{p}_draws_per_sec": round(NUTS_KEEP * n_chains / t_samp, 1),
        f"{p}_max_split_rhat": round(rhat, 4),
        f"{p}_converged": bool(rhat <= 1.01),
        f"{p}_mean_tree_depth": round(float(depth.mean()), 2),
        f"{p}_n_divergent": int(div.sum()),
        f"{p}_warmup_seconds": round(t_warm, 2),
        f"{p}_sample_seconds": round(t_samp, 2),
        f"{p}_chains": n_chains,
        f"{p}_adapted_step_size": round(float(stw.epsilon_bar[0]), 4),
        f"{p}_target_accept": NUTS_TARGET_ACCEPT,
        f"{p}_static_depth_cap": cap,
        **extra,
    }


def measure_chees_quality(log_kernel):
    """Same protocol as measure_nuts_quality for ChEES-HMC — the framework's
    accelerator-native NUTS alternative (no tree; shared jittered
    trajectories)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    import mcmc_tpu
    from mcmc_tpu import diagnostics, adaptation
    from mcmc_tpu.samplers import common
    from mcmc_tpu.samplers.chees import build_chees_kernel

    s = mcmc_tpu.ChEESSettings(n_burnin_draws=NUTS_WARMUP,
                               n_keep_draws=NUTS_KEEP)
    mass_cfg = adaptation.make_precond_cfg(NUTS_WARMUP, pooled=True,
                                           axis_name=common.CHAIN_AXIS_NAME)
    init, step = build_chees_kernel(log_kernel, jax.grad(log_kernel), s,
                                    NUTS_WARMUP, adapt_mass=True,
                                    mass_cfg=mass_cfg)
    bstep = jax.vmap(step, axis_name=common.CHAIN_AXIS_NAME)
    pos0 = 0.05 * jax.random.normal(jax.random.PRNGKey(22),
                                    (NUTS_CHAINS, DIM))
    state0 = jax.vmap(init, axis_name=common.CHAIN_AXIS_NAME)(pos0)

    def scan_phase(n, collect):
        def run(state, ks):
            def body(c, _):
                st, k = c
                pairs = jax.vmap(lambda kk: jax.random.split(kk, 2))(k)
                st, info = bstep(pairs[:, 1], st)
                out = (st.position, info["n_leap"]) if collect else None
                return (st, pairs[:, 0]), out
            (st, k), outs = lax.scan(body, (state, ks), None, length=n)
            return st, k, outs
        return jax.jit(run)

    warm = scan_phase(NUTS_WARMUP, collect=False)
    samp = scan_phase(NUTS_KEEP, collect=True)
    ks = jax.random.split(jax.random.PRNGKey(23), NUTS_CHAINS)
    stw, ks, _ = warm(state0, ks)
    jax.block_until_ready(stw)
    _st, _ks, outs = samp(stw, ks)
    jax.block_until_ready(outs[0])
    t0 = time.perf_counter()
    _st, _ks, (draws, nleap) = samp(stw, ks)
    jax.block_until_ready(draws)
    t_samp = time.perf_counter() - t0

    import numpy as np
    ess = diagnostics.ess(draws)
    rhat = float(diagnostics.split_rhat(draws).max())
    return {
        "chees_min_ess_per_sec": round(float(ess.min()) / t_samp, 1),
        "chees_max_split_rhat": round(rhat, 4),
        "chees_converged": bool(rhat <= 1.01),
        "chees_mean_n_leap": round(float(np.asarray(nleap).mean()), 2),
        "chees_trajectory_length": round(float(np.exp(stw.log_T[0])), 3),
        "chees_sample_seconds": round(t_samp, 3),
    }


def measure_ghmc_quality(log_kernel):
    """GHMC (Horowitz persistent momentum, samplers/ghmc.py) on the
    flagship posterior: 4096 chains, alpha=0.98, three leapfrogs per draw,
    thin=4, dual-averaged to 0.95 acceptance (benchmarks/ghmc_probe.py
    sweeps the trajectory length; GHMC under-warmed is fragile, so the warm
    phase runs WARMUP thinned sweeps = 4x that many transitions). Exact
    sampling. Diagnostics on device."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from mcmc_tpu import diagnostics
    from mcmc_tpu.samplers import common
    from mcmc_tpu.samplers.ghmc import build_ghmc_kernel

    N, THIN, WARM, N_LEAP = 4096, 4, 1000, 3
    precond = common.make_spd(None, DIM, jnp.float32)
    init, step = build_ghmc_kernel(
        log_kernel, jax.grad(log_kernel), precond, 0.05, 0.98, N_LEAP, 0.2,
        {"n_burnin": WARM, "target": 0.95})
    step = common.thin_step(step, THIN)
    bstep = jax.vmap(step, axis_name=common.CHAIN_AXIS_NAME)
    pos0 = 0.05 * jax.random.normal(jax.random.PRNGKey(42), (N, DIM))
    state0 = jax.vmap(init)(pos0)

    def scan_phase(n, collect):
        def run(state, ks):
            def body(c, _):
                st, k = c
                pairs = jax.vmap(lambda kk: jax.random.split(kk, 2))(k)
                st, info = bstep(pairs[:, 1], st)
                return (st, pairs[:, 0]), (st.position if collect else None)
            (st, k), outs = lax.scan(body, (state, ks), None, length=n)
            return st, k, outs
        return jax.jit(run)

    warm = scan_phase(WARM, collect=False)
    samp = scan_phase(NUTS_KEEP, collect=True)
    ks = jax.random.split(jax.random.PRNGKey(43), N)
    stw, ks, _ = warm(state0, ks)
    jax.block_until_ready(stw)
    _st, _ks, outs = samp(stw, ks)
    jax.block_until_ready(outs)
    t0 = time.perf_counter()
    _st, _ks, draws = samp(stw, ks)
    jax.block_until_ready(draws)
    t_samp = time.perf_counter() - t0

    @jax.jit
    def diag(d):
        return (diagnostics.ess(d, chain_chunk=256).min(),
                diagnostics.bulk_ess(d, chain_chunk=256).min(),
                diagnostics.tail_ess(d, chain_chunk=256).min(),
                diagnostics.split_rhat(d).max())

    ess_min, ess_bulk, ess_tail, rhat = map(float, diag(draws))
    return {
        "ghmc_min_ess_per_sec": round(ess_min / t_samp, 1),
        # tail ESS is much lower than bulk for the persistent chain
        # (coherent motion decorrelates means faster than extremes) —
        # report both so the headline can't hide it
        "ghmc_bulk_ess_per_sec": round(ess_bulk / t_samp, 1),
        "ghmc_tail_ess_per_sec": round(ess_tail / t_samp, 1),
        "ghmc_max_split_rhat": round(rhat, 4),
        "ghmc_converged": bool(rhat <= 1.01),
        "ghmc_chains": N, "ghmc_alpha": 0.98, "ghmc_thin": THIN,
        "ghmc_n_leap": N_LEAP,
        "ghmc_adapted_step_size": round(
            float(jnp.exp(stw.da.log_eps_bar[0])), 5),
        "ghmc_sample_seconds": round(t_samp, 3),
    }


def measure_microcanonical_quality(log_kernel):
    """MCLMC (unadjusted) + MAMS (exact) on the flagship posterior — the
    microcanonical family (samplers/mclmc.py). Both run 4096 chains with
    diagonal preconditioning and the minimal-norm (McLachlan) integrator;
    MCLMC runs thin=2 (benchmarks/mclmc_probe.py sweeps it: kept draws can
    be anticorrelated, so ESS per kept draw can exceed 1, which is real for
    microcanonical chains; bulk/tail ESS are reported alongside as the
    conservative check). Diagnostics stay on device (chunked-FFT ESS) —
    only scalars reach the host. The unadjusted chain's lines carry a bias
    audit against the exact sampler's moments (max |dmean|, max relative
    std diff): the O(step^2) bias at the desired_energy_var operating
    point."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    import mcmc_tpu
    from mcmc_tpu import diagnostics
    from mcmc_tpu.samplers import common
    from mcmc_tpu.samplers.mclmc import build_mclmc_kernel, build_mams_kernel

    N = 4096
    out = {}
    moments = {}
    for kind, thin in (("mams", 1), ("mclmc", 2)):
        if kind == "mclmc":
            s = mcmc_tpu.MCLMCSettings(n_burnin_draws=NUTS_WARMUP,
                                       n_keep_draws=NUTS_KEEP)
            init, step = build_mclmc_kernel(log_kernel, s, NUTS_WARMUP,
                                            adapt_mass=True)
        else:
            s = mcmc_tpu.MAMSSettings(n_burnin_draws=NUTS_WARMUP,
                                      n_keep_draws=NUTS_KEEP)
            init, step = build_mams_kernel(log_kernel, s, NUTS_WARMUP,
                                           adapt_mass=True)
        step = common.thin_step(step, thin)
        bstep = jax.vmap(step, axis_name=common.CHAIN_AXIS_NAME)
        pos0 = 0.05 * jax.random.normal(jax.random.PRNGKey(32), (N, DIM))
        ik = jax.random.split(jax.random.PRNGKey(33), N)
        state0 = jax.vmap(lambda k, x: init(k, x, float(DIM) ** 0.5,
                                            0.1 * float(DIM) ** 0.5),
                          axis_name=common.CHAIN_AXIS_NAME)(ik, pos0)

        def scan_phase(n, collect):
            def run(state, ks):
                def body(c, _):
                    st, k = c
                    pairs = jax.vmap(lambda kk: jax.random.split(kk, 2))(k)
                    st, info = bstep(pairs[:, 1], st)
                    return (st, pairs[:, 0]), (st.position if collect
                                               else None)
                (st, k), outs = lax.scan(body, (state, ks), None, length=n)
                return st, k, outs
            return jax.jit(run)

        warm = scan_phase(NUTS_WARMUP, collect=False)
        samp = scan_phase(NUTS_KEEP, collect=True)
        ks = jax.random.split(jax.random.PRNGKey(34), N)
        t0 = time.perf_counter()
        stw, ks, _ = warm(state0, ks)
        jax.block_until_ready(stw)
        t_warm = time.perf_counter() - t0
        _s, _k, outs = samp(stw, ks)          # compile off the clock
        jax.block_until_ready(outs)
        t0 = time.perf_counter()
        _s, _k, draws = samp(stw, ks)
        jax.block_until_ready(draws)
        t_samp = time.perf_counter() - t0

        @jax.jit
        def diag(d):
            return (diagnostics.ess(d, chain_chunk=512).min(),
                    diagnostics.bulk_ess(d, chain_chunk=512).min(),
                    diagnostics.tail_ess(d, chain_chunk=512).min(),
                    diagnostics.split_rhat(d).max(),
                    d.mean((0, 1)), d.std((0, 1)))

        ess_min, ess_bulk, ess_tail, rhat, mean, std = diag(draws)
        ess_min, rhat = float(ess_min), float(rhat)
        moments[kind] = (mean, std)
        out.update({
            f"{kind}_min_ess_per_sec": round(ess_min / t_samp, 1),
            f"{kind}_bulk_ess_per_sec": round(float(ess_bulk) / t_samp, 1),
            f"{kind}_tail_ess_per_sec": round(float(ess_tail) / t_samp, 1),
            f"{kind}_max_split_rhat": round(rhat, 4),
            f"{kind}_converged": bool(rhat <= 1.01),
            f"{kind}_chains": N,
            f"{kind}_warmup_seconds": round(t_warm, 2),
            f"{kind}_sample_seconds": round(t_samp, 3),
            f"{kind}_adapted_step_size": round(
                float(jnp.exp(stw.da.log_eps_bar[0])), 4),
        })
        if thin > 1:
            out[f"{kind}_thin"] = thin
    dmean = float(jnp.abs(moments["mclmc"][0] - moments["mams"][0]).max())
    dstd = float(jnp.abs(moments["mclmc"][1] / moments["mams"][1] - 1.0).max())
    out["mclmc_bias_max_abs_mean_diff"] = round(dmean, 4)
    out["mclmc_bias_max_rel_std_diff"] = round(dstd, 4)
    return out


def main():
    import jax
    from mcmc_tpu import models
    from mcmc_tpu.device import enable_compile_cache, require_accelerator

    enable_compile_cache()
    dev = require_accelerator("gpu")
    platform = dev.platform
    baseline = cpp_baseline_steps_per_sec()

    key = jax.random.PRNGKey(0)
    X, y, _ = models.make_logistic_regression_data(key, N_DATA, DIM)

    steps_per_sec, acc = measure_throughput(X, y)
    lk = models.logistic_regression_model(X, y)
    quality = measure_nuts_quality(lk)
    # the large-batch line: 4096 chains, draws device-resident, on-device
    # chunked diagnostics (no transfer, no draw-buffer blowup)
    quality.update(measure_nuts_quality(
        lk, n_chains=NUTS_BIG_CHAINS, prefix="nuts4096", device_diag=True))
    quality.update(measure_chees_quality(lk))
    quality.update(measure_ghmc_quality(lk))
    quality.update(measure_microcanonical_quality(lk))

    result = {
        "metric": "leapfrog_steps_per_sec_per_chip",
        "value": round(steps_per_sec, 1),
        "unit": "leapfrog_steps/s",
        "vs_baseline": round(steps_per_sec / baseline, 2) if baseline else None,
        "baseline_cpp_steps_per_sec": baseline,
        "platform": platform,
        "device_kind": dev.device_kind,
        "n_chains": N_CHAINS,
        "dim": DIM,
        "n_data": N_DATA,
        "accept_rate": round(acc, 4),
        "workload": "HMC+NUTS 100-d Bayesian logistic regression (BASELINE.md)",
        **quality,
    }

    # The full record is longer than a tail of stdout keeps: persist
    # everything to a file and print a COMPACT final line that is
    # guaranteed to parse: headline + per-sampler min-ESS/s + R-hat gate.
    full_path = ROOT / "benchmarks" / "bench_full_latest.json"
    full_path.write_text(json.dumps(result, indent=1))

    compact = {k: result[k] for k in
               ("metric", "value", "unit", "vs_baseline", "platform",
                "accept_rate")}
    for pfx in ("nuts", "nuts4096", "chees", "ghmc", "mclmc", "mams"):
        for suffix in ("min_ess_per_sec", "max_split_rhat", "converged"):
            k = f"{pfx}_{suffix}"
            if k in result:
                compact[k] = result[k]
    compact["full_record"] = str(full_path.relative_to(ROOT))
    line = json.dumps(compact)
    assert json.loads(line) == compact and len(line) <= 1500, len(line)
    print(line)


if __name__ == "__main__":
    main()
