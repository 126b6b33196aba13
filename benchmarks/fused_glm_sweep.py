#!/usr/bin/env python
"""Tile sweep of the fused GLM HMC kernel on the GPU, beside the plain XLA
transition, at the flagship shape: 16384 chains x (1000, 100) logistic
regression, n_leap=4, step 0.01.

    python benchmarks/fused_glm_sweep.py [--quick] [--out PATH]

For each (block_chains, obs_tile, num_warps, num_stages) it compiles the
kernel, checks one trajectory against the plain leapfrog at
precision=HIGHEST, and times the full HMC transition (best of 3 calls of a
50-transition scan, compiled off the clock). Prints one JSON line per
configuration and writes them all to ``--out``. Exits non-zero when the
default configuration fails.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

N_CHAINS, N_DATA, DIM, N_LEAP, EPS = 16384, 1000, 100, 4, 0.01


def time_transition(step, positions, n_steps, reps=3):
    """Seconds per HMC transition of a ``make_*_hmc_step`` step:
    ``n_steps`` transitions per jitted scan, compiled off the clock, best
    of ``reps`` calls; also returns the mean acceptance."""
    import jax
    from jax import lax

    @jax.jit
    def run(key, state):
        def body(carry, _):
            st, k = carry
            k, sub = jax.random.split(k)
            st, info = step(sub, st)
            return (st, k), info["accepted"].mean()
        (state, key), acc = lax.scan(body, (state, key), None, length=n_steps)
        return key, state, acc.mean()

    key = jax.random.PRNGKey(2)
    state = step.init(positions)
    key, state, acc = jax.block_until_ready(run(key, state))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        key, state, acc = jax.block_until_ready(run(key, state))
        best = min(best, time.perf_counter() - t0)
    return best / n_steps, float(acc)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="a handful of configurations around the default")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from mcmc_tpu import models
    from mcmc_tpu.device import enable_compile_cache, require_accelerator
    from mcmc_tpu.ops import fused_logreg as fl

    enable_compile_cache()
    dev = require_accelerator("gpu")
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0),
                                                   N_DATA, DIM)
    pos = 0.05 * jax.random.normal(jax.random.PRNGKey(1), (N_CHAINS, DIM))
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    z0 = 0.1 * jax.random.normal(k1, (N_CHAINS, DIM))
    p0 = jax.random.normal(k2, (N_CHAINS, DIM))
    ref = fl.make_xla_trajectory(fl.glm_log_density(X, y, 10.0), EPS, N_LEAP)
    z_ref = np.asarray(jax.jit(ref)(z0, p0)[0])

    rows = []

    def emit(row):
        row.update(device=dev.device_kind, n_chains=N_CHAINS,
                   n_data=N_DATA, dim=DIM, n_leap=N_LEAP)
        rows.append(row)
        print(json.dumps(row), flush=True)

    lk = models.logistic_regression_model(X, y)
    lk_bf16 = models.logistic_regression_model(X, y,
                                               matmul_dtype=jnp.bfloat16)
    for name, log_density in (("xla_f32_highest", lk), ("xla_bf16", lk_bf16)):
        sec, acc = time_transition(
            fl.make_xla_hmc_step(log_density, DIM, EPS, N_LEAP), pos, 50)
        emit({"impl": name, "ms_per_transition": sec * 1e3, "accept": acc})

    default = (fl.BLOCK_CHAINS, fl.OBS_TILE, fl.NUM_WARPS, fl.NUM_STAGES)
    if args.quick:
        grid = [default, (64, 64, 4, 3), (64, 64, 4, 2), (128, 32, 8, 3),
                (32, 64, 4, 3)]
    else:
        grid = list(itertools.product((32, 64, 128), (32, 64, 128), (4, 8),
                                      (2, 3)))
    default_ok = False
    for bc, tile, warps, stages in grid:
        cfg = dict(block_chains=bc, obs_tile=tile, num_warps=warps,
                   num_stages=stages)
        row = {"impl": "fused", **cfg}
        try:
            traj = fl.make_fused_trajectory(X, y, 10.0, EPS, N_LEAP, **cfg)
            Dp = traj.dim_padded
            zp = jnp.zeros((N_CHAINS, Dp)).at[:, :DIM].set(z0)
            pp = jnp.zeros((N_CHAINS, Dp)).at[:, :DIM].set(p0)
            t0 = time.perf_counter()
            z1 = np.asarray(jax.jit(traj)(zp, pp)[0][:, :DIM])
            row["compile_and_first_call_s"] = time.perf_counter() - t0
            row["max_abs_err_z"] = float(np.abs(z1 - z_ref).max())
            if not row["max_abs_err_z"] <= 2e-2:
                raise AssertionError(f"z error {row['max_abs_err_z']:.3e}")
            sec, acc = time_transition(
                fl.make_fused_hmc_step(X, y, 10.0, EPS, N_LEAP, **cfg),
                pos, 50)
            row.update(ms_per_transition=sec * 1e3, accept=acc)
            default_ok |= (bc, tile, warps, stages) == default
        except Exception as e:  # a configuration the compiler refuses
            row["error"] = f"{type(e).__name__}: {str(e)[:300]}"
        emit(row)

    ok = [r for r in rows if r["impl"] == "fused" and "ms_per_transition" in r]
    if ok:
        best = min(ok, key=lambda r: r["ms_per_transition"])
        print(json.dumps({"best": {k: best[k] for k in (
            "block_chains", "obs_tile", "num_warps", "num_stages",
            "ms_per_transition")}}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0 if default_ok else 1


if __name__ == "__main__":
    sys.exit(main())
