#!/usr/bin/env python
"""AEES ladder-efficiency sweep (VERDICT r2 item 6 / r4 item 4): run the
suite's aees_mixture config over candidate temperature ladders — the
geometric family at 3/4/5/6 rungs (the denser scan around the round-3
winner geom4), the legacy PT-Robbins-Monro adaptation
(``adapt_ladder="pt"``), and the energy-overlap auto-ladder
(``adapt_ladder=True``, the EE-functional spacing rule) — and record
min-ESS/s + rank R-hat per ladder, so the suite's choice is evidence-based
rather than folklore.

Run on the GPU, alone on the card:
    python benchmarks/aees_ladder_sweep.py --out aees_ladder_sweep.json
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

import mcmc_tpu
from mcmc_tpu import models, diagnostics

N_RUNS = 64
# geom4 runs at 32 replicas (the suite's count); min-ESS/s normalizes by
# wall, so the comparison with 64-replica ladders stands.
LADDERS = {
    "suite_60_9": [60.0, 9.0],
    "shallow_8_3": [8.0, 3.0],
    "steep_200_14": [200.0, 14.0],
    # the geometric family, denser scan (is geom4 within ~20% of
    # optimal?): K rungs incl. T=1, ratio 60^(1/(K-1))
    "geom3_60": [60.0, 7.75],
    "geom4_60": [60.0, 15.3, 3.9],
    "geom5_60": [60.0, 21.6, 7.75, 2.78],
    "geom6_60": [60.0, 26.4, 11.6, 5.1, 2.27],
    "two_rung_20": [20.0],
    "adapted_pt": "adapt_pt",   # legacy PT Robbins-Monro from suite_60_9
    "auto_ee": "adapt_ee",      # energy-overlap rule, default spacing 3.0
    "auto_ee_s2": "adapt_ee_s2",  # denser: spacing 2.0
}
_RUNS_OVERRIDE = {"geom4_60": 32, "geom5_60": 32, "geom6_60": 32,
                  "auto_ee": 32, "auto_ee_s2": 32}


def main(out_path=None, only=None):
    from mcmc_tpu.device import enable_compile_cache
    enable_compile_cache()
    mu = jnp.array([[-2.0, -2.0], [2.0, 2.0]])
    lk_hard = models.gaussian_mixture_model(mu, jnp.array([0.1, 0.1]),
                                            jnp.array([0.5, 0.5]))
    rows = []
    items = [(n, l) for n, l in LADDERS.items()
             if only is None or n in only]
    for name, ladder in items:
        kw = {}
        if ladder == "adapt_pt":
            temper = jnp.array([60.0, 9.0])
            kw["adapt_ladder"] = "pt"
        elif ladder == "adapt_ee":
            temper = jnp.array([60.0])
            kw["adapt_ladder"] = True
        elif ladder == "adapt_ee_s2":
            temper = jnp.array([60.0])
            kw.update(adapt_ladder=True, ladder_spacing=2.0)
        else:
            temper = jnp.array(ladder)
        settings = mcmc_tpu.AEESSettings(
            n_initial_draws=500, n_burnin_draws=500, n_keep_draws=24000,
            n_rings=11, ee_prob_par=0.05, temper_vec=temper,
            cov_mat=0.35 * jnp.eye(2))
        n_runs = _RUNS_OVERRIDE.get(name, N_RUNS)
        t0 = time.perf_counter()
        out = mcmc_tpu.aees(mu[0], lk_hard, settings,
                            key=jax.random.PRNGKey(8), n_runs=n_runs,
                            history_capacity=512, **kw)
        jax.block_until_ready(out.draws)
        el = time.perf_counter() - t0
        d = out.draws
        row = {
            "ladder": name,
            "n_runs": n_runs,
            "temperatures": [round(float(t), 3)
                             for t in out.diagnostics["temperatures"]],
            "seconds": round(el, 2),
            "min_ess_per_sec": round(float(diagnostics.ess(d).min()) / el, 1),
            "max_rank_rhat": round(
                float(diagnostics.rank_normalized_rhat(d).max()), 4),
            "mode_balance": round(float((jnp.asarray(d)[..., 0] > 0).mean()), 4),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    best = max(rows, key=lambda r: r["min_ess_per_sec"])
    summary = {"sweep": "aees_ladder", "n_runs": N_RUNS,
               "best": best["ladder"],
               "best_min_ess_per_sec": best["min_ess_per_sec"],
               "platform": jax.devices()[0].platform}
    print(json.dumps(summary))
    if out_path:
        pathlib.Path(out_path).write_text(
            json.dumps({"summary": summary, "ladders": rows}, indent=1))


if __name__ == "__main__":
    out = None
    names = []
    argv = sys.argv[1:]
    i = 0
    while i < len(argv):
        if argv[i] == "--out" and i + 1 < len(argv):
            out = argv[i + 1]
            i += 2
        else:
            names.append(argv[i])
            i += 1
    main(out, only=names or None)
