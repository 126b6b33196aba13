#!/usr/bin/env python
"""Smoke test of mcmc_tpu on one NVIDIA GPU: the main path, once, at the
flagship's full width, in one process.

    python chip_smoke.py               # one card; the phases below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only
    python chip_smoke.py --cpu         # CPU rehearsal at a reduced size

Phases (one card):

1. device   — JAX's first device is a GPU; the card's name and power limit.
2. precision — the flagship log density and gradient (100-d Bayesian
   logistic regression on 1000 observations) at 256 random points against
   the same math in float64 NumPy.
3. nuts     — ``mcmc_tpu.fit(algorithm="nuts")``, 1024 chains, 500 warmup,
   1000 draws: finite, max rank-normalised R-hat <= 1.01.
4. chees    — the same with ``algorithm="chees"``; posterior means agree
   with phase 3's within 5 Monte-Carlo standard errors on every coordinate.
5. fused    — the Pallas (Triton) fused GLM trajectory compiled at 16384 x
   (1000, 100) logistic and 2048 x (500, 25) probit, compared with the plain
   leapfrog at ``precision=HIGHEST``; its memory analysis; the fused HMC
   transition timed against the plain XLA one (f32 and bf16 products).
6. gpu tests — the tests marked ``gpu``, run in this process.

Any failure exits non-zero. The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def card_line() -> str:
    """nvidia-smi's name and power limit of each card (a child process that
    does not touch JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())


def log(*parts):
    print(*parts, flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise PhaseFailed(what)


# --------------------------------------------------------------------------
# shapes
# --------------------------------------------------------------------------

FULL = dict(n_data=1000, dim=100, chains=1024, warmup=500, draws=1000,
            fused_chains=16384, probit=(2048, 500, 25), time_steps=50)
# CPU rehearsal: same code, reduced scale (the full size is a GPU workload)
REHEARSAL = dict(n_data=200, dim=10, chains=64, warmup=300, draws=400,
                 fused_chains=None, probit=None, time_steps=None)


def flagship(shape):
    import jax
    from mcmc_tpu import models
    X, y, _ = models.make_logistic_regression_data(
        jax.random.PRNGKey(0), shape["n_data"], shape["dim"])
    return X, y


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_precision(shape):
    """f32 density/gradient on the device vs float64 NumPy (tolerances: the
    density to 1e-5 relative — f32 sums of 1000 terms at HIGHEST products;
    the gradient to 1e-4 relative in the 2-norm of each point)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mcmc_tpu import models

    X, y = flagship(shape)
    lk = models.logistic_regression_model(X, y)
    B = 0.3 * jax.random.normal(jax.random.PRNGKey(5), (256, shape["dim"]))
    lp, g = jax.jit(jax.vmap(jax.value_and_grad(lk)))(B)

    Xd, yd, Bd = (np.asarray(a, np.float64) for a in (X, y, B))
    eta = Bd @ Xd.T
    lp64 = (yd * eta - np.logaddexp(0.0, eta)).sum(1) \
        - 0.5 * (Bd ** 2).sum(1) / 100.0
    g64 = (yd - 1.0 / (1.0 + np.exp(-eta))) @ Xd - Bd / 100.0
    lp_err = float(np.max(np.abs(np.asarray(lp, np.float64) - lp64)
                          / np.abs(lp64)))
    g_err = float(np.max(np.linalg.norm(np.asarray(g, np.float64) - g64, axis=1)
                         / np.linalg.norm(g64, axis=1)))
    log(f"precision: max rel err density {lp_err:.3e} (tol 1e-5), "
        f"gradient {g_err:.3e} (tol 1e-4) at 256 points vs float64 NumPy")
    check(lp_err <= 1e-5, f"density rel err {lp_err:.3e} > 1e-5")
    check(g_err <= 1e-4, f"gradient rel err {g_err:.3e} > 1e-4")


def run_fit(shape, algorithm, card, mesh=None, label=None):
    """``mcmc_tpu.fit`` on the flagship; returns (posterior mean, MCSE)."""
    import jax
    import jax.numpy as jnp
    import mcmc_tpu
    from mcmc_tpu import diagnostics, models

    X, y = flagship(shape)
    t0 = time.perf_counter()
    out = mcmc_tpu.fit(jnp.zeros(shape["dim"]),
                       models.logistic_regression_model(X, y),
                       n_chains=shape["chains"], n_warmup=shape["warmup"],
                       n_draws=shape["draws"], algorithm=algorithm,
                       key=jax.random.PRNGKey(1), mesh=mesh)
    draws = jax.block_until_ready(out.draws)
    seconds = time.perf_counter() - t0
    check(draws.shape == (shape["draws"], shape["chains"], shape["dim"]),
          f"{algorithm}: draws shape {draws.shape}")
    check(bool(jnp.isfinite(draws).all()), f"{algorithm}: non-finite draws")
    rhat = float(jax.jit(lambda d: diagnostics.rank_normalized_rhat(d).max())(
        draws))
    chunk = 256 if shape["chains"] % 256 == 0 else None
    ess = diagnostics.ess(draws, chain_chunk=chunk)
    mean = draws.mean(axis=(0, 1))
    mcse = draws.std(axis=(0, 1)) / jnp.sqrt(ess)
    name = label or algorithm
    log(f"{name}: fit {seconds:.1f} s wall on {card} (first call, includes "
        f"compile); max rank R-hat {rhat:.4f}; min ESS "
        f"{float(ess.min()):.0f}; accept "
        f"{float(jnp.mean(out.n_accept_draws) / shape['draws']):.3f}")
    check(rhat <= 1.01, f"{name}: max rank R-hat {rhat:.4f} > 1.01")
    return mean, mcse


def compare_means(a, b, k, what):
    import jax.numpy as jnp
    (ma, sa), (mb, sb) = a, b
    z = jnp.abs(ma - mb) / jnp.sqrt(sa ** 2 + sb ** 2)
    worst = float(z.max())
    log(f"{what}: max |mean diff| / MCSE = {worst:.2f} (limit {k})")
    check(worst <= k, f"{what}: means differ by {worst:.2f} MCSE > {k}")


def phase_fused(shape, card):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from benchmarks.fused_glm_sweep import time_transition
    from mcmc_tpu import models
    from mcmc_tpu.ops import fused_logreg as fl

    def compare(X, y, link, n_chains, eps, n_leap, label):
        n_data, dim = X.shape
        traj = fl.make_fused_trajectory(X, y, 10.0, eps, n_leap, link=link)
        Dp = traj.dim_padded
        k1, k2 = jax.random.split(jax.random.PRNGKey(3))
        z0 = 0.1 * jax.random.normal(k1, (n_chains, dim))
        p0 = jax.random.normal(k2, (n_chains, dim))
        zp = jnp.zeros((n_chains, Dp)).at[:, :dim].set(z0)
        pp = jnp.zeros((n_chains, Dp)).at[:, :dim].set(p0)
        t0 = time.perf_counter()
        compiled = jax.jit(traj).lower(zp, pp).compile()
        log(f"fused {label}: compiled in {time.perf_counter() - t0:.1f} s; "
            f"memory_analysis: {compiled.memory_analysis()}")
        z1, p1, u1 = compiled(zp, pp)
        ref = fl.make_xla_trajectory(fl.glm_log_density(X, y, 10.0, link),
                                     eps, n_leap)
        z2, p2, u2 = jax.jit(ref)(z0, p0)
        # bf16 operands round at 2^-9 relative, so the error grows with the
        # size of the move: the tolerance is 2% of the largest change the
        # reference trajectory makes (at least 2e-2 absolute; for U, 2% of
        # its largest magnitude, at least 0.5)
        errs = {}
        for name, a, b, start, floor in (
                ("z", z1[:, :dim], z2, z0, 2e-2),
                ("p", p1[:, :dim], p2, p0, 2e-2),
                ("U", u1, u2, 0.0, 0.5)):
            a, b = np.asarray(a), np.asarray(b)
            err = float(np.abs(a - b).max())
            tol = max(floor, 2e-2 * float(np.abs(b - np.asarray(start)).max()))
            errs[name] = (err, tol)
        log(f"fused {label}: one trajectory vs plain leapfrog at HIGHEST "
            f"(bf16 products, f32 accumulation): "
            + ", ".join(f"max abs err {n} {e:.2e} (tol {t:.2e})"
                        for n, (e, t) in errs.items()))
        for n, (e, t) in errs.items():
            check(np.isfinite(e) and e <= t,
                  f"fused {label}: {n} error {e:.3e} > tolerance {t:.3e}")
        check(float(jnp.abs(z1[:, dim:]).max()) == 0.0,
              f"fused {label}: padding columns moved")

    X, y = flagship(shape)
    n_chains = shape["fused_chains"]
    compare(X, y, "logistic", n_chains, 0.01, 4,
            f"logistic {n_chains} x {tuple(X.shape)}")
    pc, pn, pd = shape["probit"]
    kx, ky = jax.random.split(jax.random.PRNGKey(18))
    Xp = 0.5 * jax.random.normal(kx, (pn, pd))
    yp = (jax.random.uniform(ky, (pn,)) < 0.5 * (1.0 + jax.lax.erf(
        Xp @ jnp.full(pd, 0.4) / jnp.sqrt(2.0)))).astype(jnp.float32)
    compare(Xp, yp, "probit", pc, 0.05, 8, f"probit {pc} x {(pn, pd)}")

    # the full HMC transition, fused kernel vs the plain XLA leapfrog over
    # jax.vmap(jax.grad(logistic_regression_model)), same RNG and accept
    dim = X.shape[1]
    pos = 0.05 * jax.random.normal(jax.random.PRNGKey(1), (n_chains, dim))
    steps = {
        "fused kernel (bf16 products)":
            fl.make_fused_hmc_step(X, y, 10.0, 0.01, 4),
        "plain XLA, f32 products (HIGHEST)":
            fl.make_xla_hmc_step(models.logistic_regression_model(X, y), dim,
                                 0.01, 4),
        "plain XLA, bf16 products":
            fl.make_xla_hmc_step(models.logistic_regression_model(
                X, y, matmul_dtype=jnp.bfloat16), dim, 0.01, 4),
    }
    times = {}
    for name, step in steps.items():
        sec, acc = time_transition(step, pos, shape["time_steps"])
        times[name] = sec
        log(f"transition {n_chains} chains x {tuple(X.shape)}, n_leap=4: "
            f"{name}: {sec * 1e3:.4f} ms "
            f"({4 * n_chains / sec:.4e} leapfrog steps/s), accept {acc:.3f}")
    fused = times["fused kernel (bf16 products)"]
    log(f"fused vs plain XLA on {card}: "
        + ", ".join(f"{fused / t:.3f}x the time of {n}"
                    for n, t in times.items() if t is not fused))


def phase_gpu_tests():
    import pytest
    os.environ["MCMC_TESTS_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-n", "0", "-p", "no:cacheprovider",
                      "tests/"])
    log(f"gpu tests: pytest exit code {int(rc)}")
    check(int(rc) == 0, f"gpu-marked tests failed (pytest exit {int(rc)})")


def four_cards(card):
    """Chain-sharded NUTS vs one card, the (chains, data) grid vs the
    unsharded density and gradient, and the collective dry run."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import mcmc_tpu
    from mcmc_tpu.parallel import (make_mesh, make_grid_mesh,
                                   data_parallel_kernel)
    import __graft_entry__

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 devices, "
          f"found {len(jax.devices())}")
    one = run_fit(FULL, "nuts", card, label="nuts one card")
    four = run_fit(FULL, "nuts", card, mesh=make_mesh(4),
                   label="nuts chain-sharded over 4 cards")
    compare_means(one, four, 3, "nuts 4 cards vs 1 card")

    X, y = flagship(FULL)
    grid = make_grid_mesh(2, 2)

    def lk_data(beta, data):
        Xa, ya = data
        eta = jnp.dot(Xa, beta, precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(ya * eta - jax.nn.softplus(eta)) \
            - 0.5 * jnp.sum(beta ** 2) / 100.0

    lk_dp = data_parallel_kernel(lk_data, (X, y), grid)
    B = 0.3 * jax.random.normal(jax.random.PRNGKey(5), (64, X.shape[1]))
    f_dp = jax.jit(jax.vmap(jax.value_and_grad(lk_dp)))
    f_1 = jax.jit(jax.vmap(jax.value_and_grad(lambda b: lk_data(b, (X, y)))))
    (lp_a, g_a), (lp_b, g_b) = f_dp(B), f_1(B)
    lp_err = float(jnp.max(jnp.abs(lp_a - lp_b) / jnp.abs(lp_b)))
    g_err = float(jnp.max(jnp.linalg.norm(g_a - g_b, axis=1)
                          / jnp.linalg.norm(g_b, axis=1)))
    log(f"grid 2x2 data-parallel density vs unsharded: max rel err "
        f"{lp_err:.2e}, gradient {g_err:.2e} (tol 1e-5)")
    check(lp_err <= 1e-5 and g_err <= 1e-5, "grid mesh density/gradient")
    out = mcmc_tpu.hmc(jnp.zeros(X.shape[1]), lk_dp,
                       mcmc_tpu.HMCSettings(step_size=0.05, n_leap_steps=4,
                                            n_burnin_draws=50,
                                            n_keep_draws=50),
                       n_chains=64, key=jax.random.PRNGKey(17), mesh=grid)
    check(bool(np.isfinite(np.asarray(out.draws)).all()),
          "grid-mesh HMC draws not finite")
    log(f"grid 2x2 data-parallel HMC: draws {tuple(out.draws.shape)} finite")
    __graft_entry__.dryrun_multichip(4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU rehearsal at a reduced size (phases 1-4)")
    args = ap.parse_args(argv)
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    from mcmc_tpu.device import (AcceleratorMissing, enable_compile_cache,
                                 require_accelerator)

    enable_compile_cache()
    try:
        dev = require_accelerator("cpu" if args.cpu else "gpu")
    except AcceleratorMissing as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    card = card_line() if not args.cpu else "cpu"
    log(f"device: {dev.platform} {dev.device_kind} x {len(jax.devices())}; "
        f"jax {jax.__version__}")
    t_start = time.perf_counter()
    if args.four_cards:
        four_cards(card)
    else:
        shape = REHEARSAL if args.cpu else FULL
        phase_precision(shape)
        nuts = run_fit(shape, "nuts", card)
        chees = run_fit(shape, "chees", card)
        compare_means(nuts, chees, 5, "chees vs nuts posterior means")
        if not args.cpu:
            phase_fused(shape, card)
            phase_gpu_tests()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
